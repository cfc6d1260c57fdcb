"""Mesh-sharded batched planning.

Counterpart of the JAX package's parallel/planner.py (make_batched_planner
:22-69): N guided samplers as one batched chain with the batch dimension
sharded across the mesh, the "planner fan-out" configuration (1,024 samplers
over the devices). Here every rank runs the module-path sampler
(guides/sampling.py ``make_sampler``) on its block of the conditions, with
the draws of the global batch (parallel/mesh.py ``batch_rows``), so the
blocks put together are the unsharded plan.
"""

from __future__ import annotations

from typing import Optional

from dadiff_tpu_torch.guides.sampling import (
    Conditions,
    ProjectionSpec,
    make_sampler,
)
from dadiff_tpu_torch.parallel.mesh import batch_rows, local_rows


def make_batched_planner(diffusion, mesh, *, batch_axis: str = "dp",
                         guide_fn=None, guide_weight: float = 1.0,
                         projection: Optional[ProjectionSpec] = None,
                         sampling_timesteps: Optional[int] = None):
    """Returns ``plan(generator, conditions, P=None, stats=None)``: the
    conditions hold the GLOBAL batch (values (B, H, D), mask); the result is
    this rank's rows of the (B, H, D) plan, rows ``[i*B/n, (i+1)*B/n)`` for
    index i of n along ``batch_axis`` (``parallel.mesh.gather_rows`` puts
    them together). The axis must divide B. ``generator`` is seeded alike on
    every rank."""
    plan = make_sampler(diffusion, guide_fn=guide_fn,
                        guide_weight=guide_weight, projection=projection,
                        sampling_timesteps=sampling_timesteps)

    def planner(generator, conditions: Conditions, P=None, stats=None):
        values = local_rows(conditions.values, mesh, batch_axis)
        with batch_rows(mesh, batch_axis):
            return plan(generator, Conditions(values, conditions.mask), P,
                        stats)

    planner.timesteps = plan.timesteps
    return planner
