"""Env name -> linear dynamics (A, B, state_dim, action_dim).

Counterpart of the JAX package's dynamics/registry.py: DYNAMICS_REGISTRY
:13, STATE_DIM_REGISTRY :22, DATASET_REGISTRY :31 and get_dynamics_for_env
:39-99, its method resolution and its fallbacks with their warnings. The
data-driven fit from pre-loaded episodes is numpy; the dataset of a minari
name needs minari, and the analytical, numerical and trajectory extractors
(dynamics/extractor.py) open a gymnasium env.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dadiff_tpu_torch.dynamics.data_driven import identify_dynamics_from_data
from dadiff_tpu_torch.dynamics.extractor import get_dynamics_extractor

# env name pattern -> dynamics method (registry.py:13-19)
DYNAMICS_REGISTRY = {
    "pointmaze": "data_driven",
    "maze": "data_driven",
    "halfcheetah": "data_driven",
    "hopper": "data_driven",
    "walker": "data_driven",
}

# physical state dims, excluding goals (registry.py:22-28)
STATE_DIM_REGISTRY = {
    "pointmaze": 4,  # [x, y, vx, vy]
    "maze": 4,
    "halfcheetah": 17,
    "hopper": 11,
    "walker": 17,
}

# env -> Minari dataset name (registry.py:31-35)
DATASET_REGISTRY = {
    "pointmaze_umaze": "D4RL/pointmaze/umaze-v2",
    "pointmaze_medium": "D4RL/pointmaze/medium-v2",
    "pointmaze_large": "D4RL/pointmaze/large-v2",
}


def get_dynamics_for_env(env_name: str, dataset_name: Optional[str] = None,
                         method: Optional[str] = None,
                         linearization_point: Optional[np.ndarray] = None,
                         episodes=None
                         ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(A, B, state_dim, action_dim) for an env (registry.py:39-99).

    ``method`` None resolves from DYNAMICS_REGISTRY (numerical for an
    unknown env). Data-driven: least squares on ``episodes`` when given,
    else on ``dataset_name`` or the env's registered dataset; where none
    loads, a maze env falls back to the analytical double integrator and
    any other to a trajectory fit, with a warning."""
    if method is None:
        method = "numerical"
        for pattern, dynamics_type in DYNAMICS_REGISTRY.items():
            if pattern in env_name.lower():
                method = dynamics_type
                break
    method = method.replace("-", "_")
    state_dim = next((d for p, d in STATE_DIM_REGISTRY.items()
                      if p in env_name.lower()), None)

    if method == "data_driven":
        if episodes is not None:
            return identify_dynamics_from_data(episodes, state_dim=state_dim)
        if dataset_name is None:
            env_key = env_name.lower().replace("-", "_").replace("_v3", "")
            dataset_name = DATASET_REGISTRY.get(env_key)
        if dataset_name is not None:
            try:
                return identify_dynamics_from_data(
                    state_dim=state_dim, dataset_name=dataset_name)
            except Exception as e:  # any source failure takes the fallback
                print(f"data-driven sysID failed ({e}); falling back")
        else:
            print(f"WARNING: no dataset resolves for {env_name}; data-driven "
                  "sysID unavailable")
        method = "analytical" if "maze" in env_name.lower() else "trajectory"
        print(f"WARNING: dynamics for {env_name} degrade to '{method}' "
              "identification"
              + (" (random-rollout fit)" if method == "trajectory" else ""))

    extractor = get_dynamics_extractor(env_name, method=method)
    try:
        if method == "trajectory" and dataset_name is not None:
            A, B = extractor.get_dynamics(use_dataset=dataset_name)
        else:
            A, B = extractor.get_dynamics(linearization_point)
        return A, B, extractor.state_dim, extractor.action_dim
    finally:
        extractor.close()
