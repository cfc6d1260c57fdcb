"""The JAX side of the port's locomotion tests, built once per process and
shared by tests/test_torch_planar_physics.py and
tests/test_torch_locomotion.py.

Each JAX env, and with it its physics engine, is made once per (env,
solver), with ``_forward`` and ``step`` wrapped in ``jax.jit`` on the
instance: JAX traces ``_forward`` once per input shape and dtype, however
many RK4 stages (four a step) and tests call it, and a test that runs a
function another test ran at the same shapes reuses its compiled code. jit
changes no value. Most of these tests' time is XLA compiling the JAX
autodiff physics (Walker2d's env step: ~0.5 s to trace, 7.5-8.7 s to
compile), so each test compiles as few programs as it can.
"""

import functools

import jax
import numpy as np

from dadiff_tpu.envs import locomotion_jax as jl

ITERS = 30
_JITTED = ("_forward", "step")


@functools.lru_cache(maxsize=None)
def env(name: str, solver: str = "pgs") -> jl.PlanarGymEnv:
    """The JAX env ``name`` on the exact model at ITERS solver iterations,
    its engine's ``_forward`` and ``step`` jitted on the instance,
    ``step_jit`` its jitted single-env step and ``smooth_jit`` one jitted
    program of the solver-free quantities: ``(qpos, qvel) -> (mass matrix,
    bias forces, potential, contact points, constraint rows)``."""
    e = jl.physics_env_for(name, solver_iters=ITERS, solver=solver)
    phys = e.phys
    for fn in _JITTED:
        setattr(phys, fn, jax.jit(getattr(phys, fn)))
    e.step_jit = jax.jit(e.step)
    e.smooth_jit = jax.jit(lambda q, v: (
        phys.mass_matrix(q), phys.bias_forces(q, v), phys._potential(q),
        phys.contact_points(q), phys._constraint_rows(q, v)))
    return e


def rows(fn, *arrays):
    """``fn`` of the JAX side on each batch row of numpy ``arrays``,
    stacked."""
    outs = [fn(*(a[i] for a in arrays)) for i in range(len(arrays[0]))]
    return jax.tree_util.tree_map(lambda *v: np.stack(v), *outs)
