"""Command-line pieces of the planning path: flags, model loading, policy
construction.

Counterpart of the JAX package's cli.py: build_eval_parser :695 (the flags this
path uses), maze_grid_for_env :810, _apply_stored_normalizer :821,
load_model :854 (the ``.pt`` branch; orbax is JAX-only) and
build_policy_from_args :992 (the dynamics-aware branch and ``--megakernel``).
Everything runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# env -> default dataset spec (cli.py:844-851); only npz/synthetic specs load
ENV_TO_DATASET = {
    "PointMaze_UMaze-v3": "npz:data/pointmaze_umaze_expert.npz",
    "PointMaze_Medium-v3": "npz:data/pointmaze_medium_expert.npz",
    "PointMaze_Large-v3": "npz:data/pointmaze_large_expert.npz",
}


def build_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Plan with a diffusion planner", allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--env", type=str, default="PointMaze_UMaze-v3")
    p.add_argument("--policy-type", type=str, default="dynamics-aware",
                   choices=["dynamics-aware"])
    p.add_argument("--action-horizon", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dataset", type=str, default=None,
                   help="dataset spec for the normalizer and the sysID "
                        "(defaults by env)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampling-timesteps", type=int, default=None,
                   help="reverse-chain step budget (default 200, clamped to "
                        "the trained chain)")
    p.add_argument("--projection-schedule", type=str, default="noise_schedule",
                   choices=["constant", "linear", "quadratic", "noise_schedule"])
    p.add_argument("--projection-strength", type=float, default=1.0)
    p.add_argument("--wall-aware", action="store_true",
                   help="revert plan rows the projection drags into maze "
                        "wall cells (PointMaze envs only)")
    p.add_argument("--wall-margin", type=float, default=None,
                   help="wall probe margin for --wall-aware (default: "
                        "center cell only)")
    p.add_argument("--n-candidates", type=int, default=1,
                   help="best-of-N candidate plans per replan")
    p.add_argument("--megakernel", action="store_true",
                   help="run each replan wave (all candidates, conditioning, "
                        "per-step projection) through the planner chain's "
                        "CUDA kernels (ops/planner.py)")
    return p


def maze_grid_for_env(env_name: str):
    """Occupancy grid of a PointMaze env name, or None (cli.py:810-818)."""
    from dadiff_tpu_torch.envs.pointmaze_jax import MAZE_MAPS

    name = env_name.lower()
    for key in ("umaze", "medium", "large", "open"):
        if key in name:
            return MAZE_MAPS[key]
    return None


def _apply_stored_normalizer(dataset, config: dict) -> None:
    """Prefer the normalization stats stored at train time over stats
    derived from the given dataset (cli.py:821-840)."""
    stats = (config or {}).get("normalizer_stats")
    if not stats:
        return
    from dadiff_tpu_torch.datasets.normalization import DatasetNormalizer

    stored = DatasetNormalizer.from_arrays(
        {k: np.asarray(v, np.float32) for k, v in stats.items()},
        normalizer_name=config.get("normalizer_name", "stored"))
    if stored.observation_dim != dataset.observation_dim or \
            stored.action_dim != dataset.action_dim:
        print("WARNING: checkpoint normalizer stats dims do not match the "
              "dataset; falling back to dataset-derived stats")
        return
    dataset.set_normalizer(stored)
    print("using checkpoint-stored normalization stats")


def load_model(checkpoint_path: str, dataset_spec: str, horizon_hint=None,
               device="cuda"):
    """Load a reference-schema ``.pt`` and the dataset normalizer, rebuild
    the model from the weight shapes and load it with ``strict=True``
    (cli.py:854-920). Returns (diffusion on ``device``, dataset)."""
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset
    from dadiff_tpu_torch.io.torch_compat import (
        infer_model_config_from_checkpoint,
        load_pt_checkpoint,
    )
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    checkpoint = load_pt_checkpoint(checkpoint_path)
    cfg = infer_model_config_from_checkpoint(checkpoint)
    saved = checkpoint.get("config", {}) or {}
    for key in ("predict_epsilon", "clip_denoised", "prediction"):
        if key in saved:
            cfg[key] = saved[key]
    horizon = horizon_hint or cfg["horizon"]
    dataset = SequenceDataset(dataset_name=dataset_spec, horizon=horizon,
                              normalizer="LimitsNormalizer",
                              max_path_length=1000, use_padding=True)
    _apply_stored_normalizer(dataset, saved)
    unet = TemporalUnet(transition_dim=dataset.transition_dim, dim=cfg["dim"],
                        dim_mults=tuple(cfg["dim_mults"]))
    diffusion = GaussianDiffusion(
        unet, horizon=horizon, observation_dim=dataset.observation_dim,
        action_dim=dataset.action_dim, n_timesteps=cfg["n_timesteps"],
        beta_schedule=cfg["beta_schedule"],
        predict_epsilon=bool(cfg.get("predict_epsilon", True)),
        clip_denoised=bool(cfg.get("clip_denoised", True)),
        prediction=cfg.get("prediction"),
    )
    diffusion.load_state_dict(checkpoint["model_state_dict"], strict=True)
    return diffusion.to(device).eval(), dataset


def build_policy_from_args(args, diffusion, dataset, dataset_spec: str,
                           sampling_timesteps: int):
    """The dynamics-aware policy an eval-parser namespace describes, wired
    to the planner chain with ``--megakernel`` (cli.py:1086-1158)."""
    from dadiff_tpu_torch.datasets.sources import load_episodes
    from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
    from dadiff_tpu_torch.dynamics.registry import get_dynamics_for_env
    from dadiff_tpu_torch.guides.policies import DynamicsAwarePolicy

    A, B, state_dim, action_dim = get_dynamics_for_env(
        args.env, episodes=load_episodes(dataset_spec))
    P = ProjectionMatrixBuilder(A, B, state_dim, action_dim).get_projection_matrix(
        diffusion.horizon)
    wall_grid = None
    if args.wall_aware:
        wall_grid = maze_grid_for_env(args.env)
        if wall_grid is None:
            raise SystemExit(f"--wall-aware: no maze map for {args.env}")
    policy = DynamicsAwarePolicy(
        diffusion, projection_matrix=P, normalizer=dataset.normalizer,
        state_dim=state_dim, projection_schedule=args.projection_schedule,
        projection_strength=args.projection_strength,
        action_horizon=args.action_horizon,
        sampling_timesteps=sampling_timesteps, wall_grid=wall_grid,
        wall_margin=args.wall_margin, seed=args.seed,
        n_candidates=args.n_candidates,
    )
    if args.megakernel:
        from dadiff_tpu_torch.ops.planner import wire_policy_megakernel

        wire_policy_megakernel(policy, n_candidates=args.n_candidates)
        print(f"planner-chain path: bo{args.n_candidates} per replan wave "
              f"through the CUDA kernels")
    return policy


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) must find a card: no silent CPU fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    return torch.device(name)
