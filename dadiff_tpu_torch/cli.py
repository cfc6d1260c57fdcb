"""Command-line pieces: training, consistency distillation, and the
planning path's flags, model loading and policy construction.

Counterpart of the JAX package's cli.py: build_train_parser :57 and train_main
:147 (the U-Net family and the flagship flags, fine-tune and resume
included; ``--model-type transformer``, ``--mesh-dp``, ``--config`` and
``--dtype`` are not ported), distill_main :509 (the consistency method;
``--method progressive`` is not ported), build_eval_parser :695 (the flags
of what is ported, the samplers, warm start and ``--parity-mode``
included: a flag of a feature the port lacks, such as
``--value-checkpoint`` or ``--replan-deviation``, is refused by argparse),
maze_grid_for_env :810, _apply_stored_normalizer :821, load_model :854 (the
``.pt`` branch, EMA weights and the checkpoint's config included; orbax is
JAX-only), build_policy_from_args :992 (the dynamics-aware branch and
``--megakernel``) and evaluate_main :1162. Everything runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

# env -> default dataset spec (cli.py:844-851); only npz/synthetic specs load
ENV_TO_DATASET = {
    "PointMaze_UMaze-v3": "npz:data/pointmaze_umaze_expert.npz",
    "PointMaze_Medium-v3": "npz:data/pointmaze_medium_expert.npz",
    "PointMaze_Large-v3": "npz:data/pointmaze_large_expert.npz",
}


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train/Fine-tune a diffusion planner", allow_abbrev=False)
    # Dataset
    p.add_argument("--dataset", type=str, default="synthetic:pointmaze",
                   help="dataset spec: synthetic:* | npz:*")
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--normalizer", type=str, default="LimitsNormalizer",
                   choices=["LimitsNormalizer", "GaussianNormalizer"])
    p.add_argument("--max-path-length", type=int, default=1000)
    # Model
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--dim-mults", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--kernel-size", type=int, default=5)
    p.add_argument("--n-timesteps", type=int, default=200)
    p.add_argument("--beta-schedule", type=str, default="cosine",
                   choices=["linear", "cosine"])
    p.add_argument("--loss-type", type=str, default="l2", choices=["l1", "l2"])
    p.add_argument("--predict-epsilon", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="model predicts noise (default) vs x0 directly")
    p.add_argument("--prediction", type=str, default=None,
                   choices=["epsilon", "x0", "v"],
                   help="explicit parameterization; overrides "
                        "--predict-epsilon when given")
    p.add_argument("--clip-denoised", action=argparse.BooleanOptionalAction,
                   default=True)
    # Training
    p.add_argument("--n-epochs", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps, whatever the epoch")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=2000)
    p.add_argument("--gradient-clip", type=float, default=4.0)
    # Fine-tuning
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--finetune-mode", action="store_true")
    # Loss composition and dynamics
    p.add_argument("--projection-weight", type=float, default=0.0)
    p.add_argument("--env", type=str, default="PointMaze_UMaze-v3")
    p.add_argument("--dynamics-method", type=str, default="data-driven",
                   choices=["data-driven", "none"])
    # EMA
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction,
                   default=True, help="EMA shadow params (--no-use-ema off)")
    p.add_argument("--ema-decay", type=float, default=0.995)
    # Logging
    p.add_argument("--log-dir", type=str, default="./logs")
    p.add_argument("--save-freq", type=int, default=10000)
    p.add_argument("--eval-freq", type=int, default=5000)
    p.add_argument("--log-freq", type=int, default=50)
    p.add_argument("--run-name", type=str, default=None)
    # System
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-export-pt", action="store_true",
                   help="skip reference-schema .pt checkpoint export")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the latest checkpoint in the log dir")
    p.add_argument("--skip-nonfinite", action="store_true",
                   help="skip updates from batches with non-finite gradients")
    return p


def train_main(argv=None) -> str:
    """Train or fine-tune a U-Net planner; returns the log directory, which
    holds the train states, the reference-schema ``.pt`` exports,
    ``metrics.jsonl`` and the configs (cli.py:147-350)."""
    from dadiff_tpu_torch.datasets.sequence import (
        SequenceDataset,
        create_dataloader,
    )
    from dadiff_tpu_torch.losses import build_loss
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
    from dadiff_tpu_torch.utils.training import (
        Trainer,
        count_parameters,
        save_config,
    )

    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)

    mode = "Fine-tuning" if args.checkpoint else "Training"
    print(f"=== {mode}: dataset={args.dataset} horizon={args.horizon} "
          f"device={device} ===")
    safe_ds = args.dataset.replace("/", "_").replace(":", "_")
    log_dir = Path(args.log_dir) / safe_ds
    if args.run_name:
        log_dir = log_dir / args.run_name
    log_dir.mkdir(parents=True, exist_ok=True)
    save_config(vars(args), str(log_dir / "config.json"))

    # fine-tune / resume from a .pt: the architecture comes from the weights
    checkpoint = None
    if args.checkpoint:
        from dadiff_tpu_torch.io.torch_compat import (
            infer_model_config_from_checkpoint,
            load_pt_checkpoint,
        )

        checkpoint = load_pt_checkpoint(args.checkpoint)
        inferred = infer_model_config_from_checkpoint(checkpoint)
        args.dim, args.dim_mults = inferred["dim"], inferred["dim_mults"]
        args.n_timesteps = inferred["n_timesteps"]
        args.beta_schedule = inferred["beta_schedule"]
        args.horizon = inferred["horizon"]
        print(f"checkpoint config inferred: dim={args.dim} "
              f"mults={args.dim_mults} T={args.n_timesteps} "
              f"horizon={args.horizon}")

    dataset = SequenceDataset(
        dataset_name=args.dataset, horizon=args.horizon,
        normalizer=args.normalizer, max_path_length=args.max_path_length)
    loader = create_dataloader(dataset, batch_size=args.batch_size,
                               shuffle=True, num_workers=args.num_workers,
                               seed=args.seed)
    print(f"dataset: {len(dataset)} windows, obs={dataset.observation_dim} "
          f"act={dataset.action_dim}")
    if checkpoint is not None:
        # the pretrained weights expect the ORIGINAL dataset's scaling
        _apply_stored_normalizer(dataset, checkpoint.get("config", {}))

    unet = TemporalUnet(
        transition_dim=dataset.transition_dim, dim=args.dim,
        dim_mults=tuple(args.dim_mults), kernel_size=args.kernel_size)
    diffusion = GaussianDiffusion(
        unet, horizon=args.horizon, observation_dim=dataset.observation_dim,
        action_dim=dataset.action_dim, n_timesteps=args.n_timesteps,
        beta_schedule=args.beta_schedule, loss_type=args.loss_type,
        predict_epsilon=args.predict_epsilon,
        clip_denoised=args.clip_denoised, prediction=args.prediction)
    if checkpoint is not None:
        diffusion.load_state_dict(checkpoint["model_state_dict"], strict=True)
    diffusion.to(device)

    projection_matrix, state_dim = None, None
    if args.projection_weight > 0 and args.dynamics_method != "none":
        from dadiff_tpu_torch.datasets.sources import load_episodes
        from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
        from dadiff_tpu_torch.dynamics.registry import get_dynamics_for_env

        A, B, state_dim, act_dim = get_dynamics_for_env(
            args.env, episodes=load_episodes(args.dataset))
        projection_matrix = ProjectionMatrixBuilder(
            A, B, state_dim, act_dim).get_projection_matrix(args.horizon)
        print(f"projection loss enabled: state_dim={state_dim} "
              f"P{projection_matrix.shape}")
    loss_fn, loss_names = build_loss(
        diffusion, projection_weight=args.projection_weight,
        projection_matrix=projection_matrix, normalizer=dataset.normalizer,
        state_dim=state_dim)

    lr = args.lr
    if args.finetune_mode and not args.reset_optimizer:
        lr = args.lr * 0.1
        print(f"fine-tune mode: lr -> {lr}")
    # held-out probe batch from the tail of the window index
    val_batch = None
    if args.eval_freq and len(dataset) > 512:
        val_batch = dataset.get_batch(
            np.arange(len(dataset) - 256, len(dataset)))

    trainer = Trainer(
        diffusion, loader, loss_fn, lr=lr,
        warmup_steps=args.warmup_steps
        if (args.reset_optimizer or not args.checkpoint) else 0,
        total_steps=args.n_epochs * len(loader),
        gradient_clip=args.gradient_clip, use_ema=args.use_ema,
        ema_decay=args.ema_decay, log_dir=str(log_dir),
        save_freq=args.save_freq, eval_freq=args.eval_freq,
        log_freq=args.log_freq, loss_names=loss_names, seed=args.seed,
        export_pt=not args.no_export_pt, skip_nonfinite=args.skip_nonfinite,
        val_batch=val_batch, normalizer=dataset.normalizer)
    print(f"model parameters: {count_parameters(diffusion.model):,}")

    start_epoch = 0
    if checkpoint is not None and not args.reset_optimizer:
        start_epoch = int(checkpoint.get("epoch", 0))
    if args.resume:
        resumed_epoch = trainer.load_latest()
        if resumed_epoch is not None:
            start_epoch = resumed_epoch
            print(f"auto-resumed at step {trainer.global_step} "
                  f"(epoch {start_epoch})")
    try:
        trainer.train(args.n_epochs, start_epoch=start_epoch,
                      max_steps=args.max_steps)
    finally:
        trainer.close()

    final_config = {
        **trainer._config_dict(), "projection_weight": args.projection_weight,
        "loss_components": loss_names, "normalizer": args.normalizer,
        "dataset": args.dataset,
    }
    with open(log_dir / "final_config.json", "w") as f:
        json.dump(final_config, f, indent=2)
    print(f"{mode} complete. Logs: {log_dir}")
    return str(log_dir)


def build_distill_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Consistency-distill a trained diffusion planner",
        allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="teacher checkpoint (.pt)")
    p.add_argument("--dataset", type=str, required=True,
                   help="training dataset spec (same data the teacher saw)")
    p.add_argument("--n-epochs", type=int, default=40)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps, whatever the epoch")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=200)
    p.add_argument("--gradient-clip", type=float, default=1.0)
    p.add_argument("--target-ema-decay", type=float, default=0.95,
                   help="decay of the CD target network theta^- (the "
                        "trainer's EMA shadow)")
    p.add_argument("--sigma-data", type=float, default=0.5)
    p.add_argument("--huber-c", type=float, default=None,
                   help="pseudo-Huber c (default: iCT's 0.00054*sqrt(H*D))")
    p.add_argument("--skip-steps", type=int, default=1,
                   help="teacher DDIM gap k per consistency pair (t, t-k) — "
                        "LCM's skipping-step; larger k = stronger signal per "
                        "pair, coarser ODE discretization")
    p.add_argument("--teacher-ema", action="store_true",
                   help="distill from the teacher's EMA weights")
    p.add_argument("--log-dir", type=str, default="./logs")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--save-freq", type=int, default=10000)
    p.add_argument("--log-freq", type=int, default=50)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true",
                   help="auto-resume the student from the run dir's latest "
                        "checkpoint (runs --n-epochs MORE epochs)")
    p.add_argument("--method", type=str, default="consistency",
                   choices=["consistency", "progressive"],
                   help="consistency = 1-4-call CM student "
                        "(models/consistency.py); progressive is not "
                        "ported")
    return p


def distill_main(argv=None) -> str:
    """Distill a trained DDPM planner into a consistency student that plans
    in 1-4 model calls (cli.py:509-690, the consistency method). The
    student starts from the teacher's weights; the trainer's EMA shadow is
    the CD target network; the checkpoints are the reference ``.pt`` schema
    with ``consistency: true`` in their config. Returns the log directory."""
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.models.consistency import make_cd_loss
    from dadiff_tpu_torch.utils.training import (
        Trainer,
        count_parameters,
        save_config,
    )

    args = build_distill_parser().parse_args(argv)
    if args.method == "progressive":
        raise NotImplementedError(
            "progressive distillation is not ported yet (ROADMAP.md, Queue 1 "
            "item 6: models/progressive.py)")
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)
    diffusion, dataset = load_model(args.checkpoint, args.dataset,
                                    device=device, use_ema=args.teacher_ema)
    if dataset.checkpoint_config.get("consistency"):
        # a teacher DDIM step through a consistency network would train on
        # garbage targets
        raise SystemExit(
            "checkpoint is already a consistency-distilled student "
            "(config consistency=true); distill from the DDPM teacher "
            "checkpoint instead")
    print(f"teacher: horizon={diffusion.horizon} T={diffusion.n_timesteps} "
          f"params={count_parameters(diffusion.model):,} device={device}")
    loader = create_dataloader(dataset, batch_size=args.batch_size,
                               shuffle=True, num_workers=args.num_workers,
                               seed=args.seed)
    safe_ds = args.dataset.replace("/", "_").replace(":", "_")
    log_dir = Path(args.log_dir) / safe_ds / (args.run_name or args.method)
    log_dir.mkdir(parents=True, exist_ok=True)
    save_config(vars(args), str(log_dir / "config.json"))

    # the student trains the loaded module in place: it starts as the
    # teacher, whose weights stay frozen in this copy
    teacher = {n: p.detach().clone() for n, p in diffusion.named_parameters()}
    loss_fn = make_cd_loss(diffusion, teacher, sigma_data=args.sigma_data,
                           huber_c=args.huber_c, skip_steps=args.skip_steps)
    trainer = Trainer(
        diffusion, loader, loss_fn, lr=args.lr,
        warmup_steps=args.warmup_steps,
        total_steps=args.n_epochs * len(loader),
        gradient_clip=args.gradient_clip, use_ema=True,
        ema_decay=args.target_ema_decay, log_dir=str(log_dir),
        save_freq=args.save_freq, eval_freq=0, log_freq=args.log_freq,
        loss_names=["consistency"], seed=args.seed,
        normalizer=dataset.normalizer, loss_takes_ema=True,
        extra_config={"consistency": True, "sigma_data": args.sigma_data,
                      "teacher_checkpoint": args.checkpoint,
                      "skip_steps": args.skip_steps})
    start_epoch = 0
    if args.resume:
        resumed_epoch = trainer.load_latest()
        if resumed_epoch is not None:
            start_epoch = resumed_epoch
            print(f"auto-resumed at step {trainer.global_step} "
                  f"(epoch {start_epoch})")
    try:
        trainer.train(args.n_epochs, start_epoch=start_epoch,
                      max_steps=args.max_steps)
    finally:
        trainer.close()
    print(f"Distillation complete. Logs: {log_dir}")
    return str(log_dir)


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
                   help="reverse-chain step budget (default: 200, or 4 "
                        "model calls for --sampler consistency)")
    p.add_argument("--projection-schedule", type=str, default="noise_schedule",
                   choices=["constant", "linear", "quadratic", "noise_schedule"])
    p.add_argument("--projection-strength", type=float, default=1.0)
    p.add_argument("--parity-mode", action="store_true",
                   help="reproduce the reference's as-implemented sampling "
                        "(projection NOT applied during denoising)")
    p.add_argument("--wall-aware", action="store_true",
                   help="revert plan rows the projection drags into maze "
                        "wall cells (PointMaze envs only)")
    p.add_argument("--wall-margin", type=float, default=None,
                   help="wall probe margin for --wall-aware (default: "
                        "center cell only)")
    p.add_argument("--sampler", type=str, default="ddpm",
                   choices=["ddpm", "ddim", "dpmpp", "consistency"],
                   help="ddim/dpmpp = strided fast sampling (with conditioning/"
                        "projection composed); consistency = few-step "
                        "multistep sampling with a distilled student checkpoint "
                        "(python -m dadiff_tpu_torch.distill) — "
                        "--sampling-timesteps is the model-call budget "
                        "(default 4)")
    p.add_argument("--n-candidates", type=int, default=1,
                   help="best-of-N candidate plans per replan")
    p.add_argument("--warm-start-t", type=int, default=None,
                   help="receding-horizon warm start: replans re-noise the "
                        "previous plan (shifted by the executed steps) to "
                        "this timestep and denoise only t<K — ~T/K fewer "
                        "model calls per replan after the first")
    p.add_argument("--warm-start-auto", action="store_true",
                   help="adaptive warm-start depth: pick each replan's "
                        "re-noise depth from the measured drift between the "
                        "executed observation and the previous plan (full "
                        "chain when the drift is too large to re-noise "
                        "over) — no per-task K tuning")
    p.add_argument("--megakernel", action="store_true",
                   help="run each replan wave (all candidates, conditioning, "
                        "per-step projection) through the planner chain's "
                        "CUDA kernels (ops/planner.py); ddpm only")
    p.add_argument("--use-ema", action="store_true",
                   help="plan with the EMA weights if the checkpoint has them")
    # the evaluation protocol (evaluate_main)
    p.add_argument("--n-episodes", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--render", type=str, default="none", choices=["none"])
    p.add_argument("--results-dir", type=str, default="./results")
    p.add_argument("--batched", action="store_true",
                   help="run all episodes in lockstep with batched replans "
                        "(per-env seeding, not the sequential protocol)")
    p.add_argument("--save-episodes", type=str, default=None,
                   help="save the executed episodes as an npz dataset "
                        "(requires --batched)")
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
               device="cuda", use_ema: bool = False):
    """Load a reference-schema ``.pt`` and the dataset normalizer, rebuild
    the model from the weight shapes and load it with ``strict=True``: the
    EMA weights if ``use_ema`` and the checkpoint has them, else the model's
    (cli.py:854-920). Returns (diffusion on ``device``, dataset); the
    dataset's ``checkpoint_config`` is the checkpoint's stored config."""
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset
    from dadiff_tpu_torch.io.torch_compat import (
        infer_model_config_from_checkpoint,
        load_pt_checkpoint,
    )

    checkpoint = load_pt_checkpoint(checkpoint_path)
    horizon = horizon_hint or infer_model_config_from_checkpoint(
        checkpoint)["horizon"]
    dataset = SequenceDataset(dataset_name=dataset_spec, horizon=horizon,
                              normalizer="LimitsNormalizer",
                              max_path_length=1000, use_padding=True)
    _apply_stored_normalizer(dataset, checkpoint.get("config", {}) or {})
    # the checkpoint's provenance, e.g. the consistency student's marker
    dataset.checkpoint_config = dict(checkpoint.get("config", {}) or {})
    diffusion = diffusion_from_checkpoint(
        checkpoint, dataset.observation_dim, dataset.action_dim, horizon,
        use_ema=use_ema)
    return diffusion.to(device).eval(), dataset


def diffusion_from_checkpoint(checkpoint: dict, observation_dim: int,
                              action_dim: int, horizon: int,
                              use_ema: bool = False):
    """Rebuild the GaussianDiffusion of a loaded reference-schema checkpoint
    from its weight shapes and stored flags, and load it with
    ``strict=True`` (on the CPU): ``ema_state_dict`` if ``use_ema`` and the
    checkpoint has one, else ``model_state_dict`` (cli.py:912)."""
    from dadiff_tpu_torch.io.torch_compat import (
        infer_model_config_from_checkpoint,
    )
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    cfg = infer_model_config_from_checkpoint(checkpoint)
    saved = checkpoint.get("config", {}) or {}
    for key in ("predict_epsilon", "clip_denoised", "prediction"):
        if key in saved:
            cfg[key] = saved[key]
    unet = TemporalUnet(transition_dim=observation_dim + action_dim,
                        dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]))
    diffusion = GaussianDiffusion(
        unet, horizon=horizon, observation_dim=observation_dim,
        action_dim=action_dim, n_timesteps=cfg["n_timesteps"],
        beta_schedule=cfg["beta_schedule"],
        predict_epsilon=bool(cfg.get("predict_epsilon", True)),
        clip_denoised=bool(cfg.get("clip_denoised", True)),
        prediction=cfg.get("prediction"),
    )
    state_key = "ema_state_dict" if (use_ema and checkpoint.get(
        "ema_state_dict")) else "model_state_dict"
    diffusion.load_state_dict(checkpoint[state_key], strict=True)
    return diffusion


def build_policy_from_args(args, diffusion, dataset, dataset_spec: str,
                           sampling_timesteps: int):
    """The dynamics-aware policy an eval-parser namespace describes, wired
    to the planner chain with ``--megakernel`` (cli.py:1086-1158), which
    raises for a sampler other than ddpm and for warm start."""
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
        sampling_timesteps=sampling_timesteps, parity_mode=args.parity_mode,
        wall_grid=wall_grid, wall_margin=args.wall_margin, seed=args.seed,
        n_candidates=args.n_candidates, sampler=args.sampler,
        warm_start_t=args.warm_start_t,
        warm_start_auto=args.warm_start_auto,
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


def planning_timesteps(args, diffusion, dataset) -> int:
    """The guards of a checkpoint against ``--sampler`` and the step budget
    (cli.py:1184-1210): a consistency student must plan with ``--sampler
    consistency`` (the reverse warns); ``--sampling-timesteps`` defaults to
    4 model calls for consistency (at most 16) and 200 otherwise, clamped to
    the trained chain."""
    is_cm = bool(dataset.checkpoint_config.get("consistency"))
    if is_cm and args.sampler != "consistency":
        raise SystemExit(
            "checkpoint is a consistency-distilled student (config "
            "consistency=true); evaluate it with --sampler consistency")
    if args.sampler == "consistency" and not is_cm:
        print("WARNING: --sampler consistency with a checkpoint not marked "
              "as distilled — expect garbage unless this really is a "
              "consistency model")
    if args.sampling_timesteps is None:
        args.sampling_timesteps = 4 if args.sampler == "consistency" else 200
    elif args.sampler == "consistency" and args.sampling_timesteps > 16:
        raise SystemExit(
            f"--sampler consistency interprets --sampling-timesteps as the "
            f"model-call budget (<= 16); got {args.sampling_timesteps}. "
            f"Omit the flag for the default budget of 4.")
    steps = min(args.sampling_timesteps, diffusion.n_timesteps)
    if steps != args.sampling_timesteps:
        print(f"clamping sampling timesteps {args.sampling_timesteps} -> "
              f"{steps} (trained {diffusion.n_timesteps})")
    return steps


def evaluate_main(argv=None) -> dict:
    """Evaluate a planner on a gymnasium env (cli.py:1162-1286): load the
    checkpoint (``--use-ema``: its EMA weights), check it against
    ``--sampler``, build the dynamics-aware policy, run the sequential
    protocol or, with ``--batched``, all episodes in lockstep, and write the
    timestamped results JSON with the JAX package's keys. Returns the
    metrics."""
    args = build_eval_parser().parse_args(argv)
    device = resolve_device(args.device)
    from dadiff_tpu_torch.envs.host import evaluate_policy, make_env, save_results

    dataset_spec = args.dataset or ENV_TO_DATASET.get(args.env)
    if dataset_spec is None:
        raise SystemExit(f"No default dataset for {args.env}; pass --dataset")
    if args.save_episodes and not args.batched:
        raise SystemExit("--save-episodes requires --batched")
    print(f"=== Evaluating {args.policy_type} on {args.env} "
          f"(checkpoint {args.checkpoint}) ===")
    diffusion, dataset = load_model(args.checkpoint, dataset_spec,
                                    device=device, use_ema=args.use_ema)
    sampling_timesteps = planning_timesteps(args, diffusion, dataset)
    policy = build_policy_from_args(args, diffusion, dataset, dataset_spec,
                                    sampling_timesteps)
    if args.batched:
        from dadiff_tpu_torch.envs.vector_eval import evaluate_policy_batched

        metrics = evaluate_policy_batched(
            policy, args.env, n_episodes=args.n_episodes,
            max_steps=args.max_steps, seed=args.seed,
            record_episodes=bool(args.save_episodes))
        recorded = metrics.pop("recorded_episodes", None)
        if args.save_episodes and recorded is not None:
            from dadiff_tpu_torch.datasets.sources import save_episodes_npz

            save_episodes_npz(args.save_episodes, recorded)
            print(f"saved {len(recorded)} executed episodes -> "
                  f"{args.save_episodes}")
    else:
        env = make_env(args.env, render=args.render)
        env.reset(seed=args.seed)
        try:
            metrics = evaluate_policy(policy, env, n_episodes=args.n_episodes,
                                      max_steps=args.max_steps)
        finally:
            env.close()
    path = save_results(
        metrics, policy_type=args.policy_type, env_name=args.env,
        results_dir=args.results_dir, checkpoint=args.checkpoint,
        dataset=dataset_spec, n_episodes=args.n_episodes,
        sampling_timesteps=sampling_timesteps, seed=args.seed,
        extra={
            # the JAX package's provenance keys; the port plans with the
            # goal scorer and the plan's own actions
            "sampler": args.sampler,
            "n_candidates": args.n_candidates,
            "candidate_scorer": "goal",
            "wall_penalty_weight": None,
            "action_source": "plan",
            "batched": args.batched,
            "wall_aware": args.wall_aware,
            "wall_margin": args.wall_margin,
            "parity_mode": args.parity_mode,
            "projection_schedule": args.projection_schedule,
            "projection_strength": args.projection_strength,
            "action_horizon": args.action_horizon,
            "warm_start_t": args.warm_start_t,
            "replan_deviation": None,
            "guide_weight": None,
            "value_checkpoint": None,
            "use_ema": args.use_ema,
        })
    print(f"Mean reward: {metrics['mean_reward']:.2f} ± "
          f"{metrics['std_reward']:.2f}")
    print(f"Mean length: {metrics['mean_length']:.2f} "
          f"success rate: {metrics['success_rate']:.2f}")
    print(f"Results: {path}")
    return metrics
