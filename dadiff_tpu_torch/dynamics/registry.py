"""Env name -> linear dynamics (A, B, state_dim, action_dim).

Counterpart of the JAX package's dynamics/registry.py:39 get_dynamics_for_env,
the ``data_driven`` branch with pre-loaded episodes only. The analytical and
trajectory extractors are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dadiff_tpu_torch.dynamics.data_driven import identify_dynamics_from_data

# physical state dims, excluding goals (registry.py:23-29)
STATE_DIM_REGISTRY = {
    "pointmaze": 4,  # [x, y, vx, vy]
    "maze": 4,
    "halfcheetah": 17,
    "hopper": 11,
    "walker": 17,
}


def get_dynamics_for_env(env_name: str, episodes=None,
                         method: str = "data_driven"
                         ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Least-squares sysID on ``episodes`` over the env's physical state
    dims (registry.py:68-70)."""
    if method.replace("-", "_") != "data_driven" or episodes is None:
        raise NotImplementedError(
            "only data-driven dynamics from pre-loaded episodes are ported")
    state_dim = next((d for p, d in STATE_DIM_REGISTRY.items()
                      if p in env_name.lower()), None)
    return identify_dynamics_from_data(episodes, state_dim=state_dim)
