"""Command-line pieces: training, distillation, and the planning path's
flags, model loading and policy construction.

Counterpart of the JAX package's cli.py: build_train_parser :57 and train_main
:147 (both model families, the U-Net and the transformer of
``--model-type``, and the flagship flags, fine-tune and resume included;
``--mesh-dp``, ``--config`` and ``--dtype`` are not ported), distill_main
:509 (``--method consistency`` and ``--method progressive``),
train_value_main :358 and load_value_checkpoint :463 (a ``.pt`` with the
JAX checkpoint's config keys; orbax is JAX-only), build_eval_parser :695
(its flags, defaults and choices, ``--policy-type`` defaulting to mpc;
``--video-dir`` is not ported and refused by argparse), maze_grid_for_env
:810, _apply_stored_normalizer :821, load_model :854 (the ``.pt`` branch
of either family, EMA weights and the checkpoint's config included),
build_policy_from_args :1002 (every policy type, the scorers and
``--megakernel``, which takes a U-Net only) and evaluate_main :1162.
Everything runs on the card unless ``--device cpu`` is given.
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
    p.add_argument("--model-type", type=str, default="unet",
                   choices=["unet", "transformer"],
                   help="denoiser family: conv U-Net (reference parity) or "
                        "DiT-style temporal transformer")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--dim-mults", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--kernel-size", type=int, default=5)
    p.add_argument("--depth", type=int, default=4,
                   help="transformer blocks (model-type=transformer)")
    p.add_argument("--n-heads", type=int, default=4,
                   help="attention heads (model-type=transformer)")
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


def build_denoiser(model_type: str, transition_dim: int, *, dim: int,
                   dim_mults=(1, 2, 4), kernel_size: int = 5, depth: int = 4,
                   n_heads: int = 4, mlp_ratio: int = 4):
    """The denoiser of ``--model-type`` (cli.py:224-244 and :947-962)."""
    if model_type == "transformer":
        from dadiff_tpu_torch.models.temporal_transformer import (
            TemporalTransformer,
        )

        return TemporalTransformer(transition_dim, dim=dim, depth=depth,
                                   n_heads=n_heads, mlp_ratio=mlp_ratio)
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    return TemporalUnet(transition_dim, dim=dim, dim_mults=tuple(dim_mults),
                        kernel_size=kernel_size)


def train_main(argv=None) -> str:
    """Train or fine-tune a planner of either family; returns the log
    directory, which holds the train states, the ``.pt`` exports,
    ``metrics.jsonl`` and the configs (cli.py:147-350)."""
    from dadiff_tpu_torch.datasets.sequence import (
        SequenceDataset,
        create_dataloader,
    )
    from dadiff_tpu_torch.losses import build_loss
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
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
        args.model_type = inferred["model_type"]
        args.dim, args.dim_mults = inferred["dim"], inferred["dim_mults"]
        if args.model_type == "transformer":
            args.depth, args.n_heads = inferred["depth"], inferred["n_heads"]
        args.n_timesteps = inferred["n_timesteps"]
        args.beta_schedule = inferred["beta_schedule"]
        args.horizon = inferred["horizon"]
        print(f"checkpoint config inferred: {args.model_type} "
              f"dim={args.dim} mults={args.dim_mults} T={args.n_timesteps} "
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

    denoiser = build_denoiser(
        args.model_type, dataset.transition_dim, dim=args.dim,
        dim_mults=args.dim_mults, kernel_size=args.kernel_size,
        depth=args.depth, n_heads=args.n_heads)
    diffusion = GaussianDiffusion(
        denoiser, horizon=args.horizon, observation_dim=dataset.observation_dim,
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
        description="Distill a trained diffusion planner (consistency or "
                    "progressive)", allow_abbrev=False)
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
                        "(models/consistency.py); progressive = "
                        "Salimans-Ho step-halving rounds "
                        "(models/progressive.py): the student stays a "
                        "standard eps-model evaluated with --sampler ddim "
                        "--sampling-timesteps <target-steps>")
    p.add_argument("--target-steps", type=int, default=6,
                   help="progressive: final model-call budget (halving "
                        "rounds T/2 -> ... -> target; --n-epochs applies "
                        "PER ROUND)")
    return p


def distill_main(argv=None) -> str:
    """Distill a trained DDPM planner (cli.py:509-690). ``--method
    consistency``: a consistency student that plans in 1-4 model calls; it
    starts from the teacher's weights, the trainer's EMA shadow is the CD
    target network, and its checkpoints carry ``consistency: true``.
    ``--method progressive``: halving rounds down to ``--target-steps``
    (:600-636), each round's student starting from (and distilling) the
    previous round's, without EMA, at seed ``seed + r``, in
    ``round_{r}_steps{S}``; its checkpoints carry ``progressive`` and
    ``progressive_steps``. Returns the log directory."""
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.models.consistency import make_cd_loss
    from dadiff_tpu_torch.utils.training import (
        Trainer,
        count_parameters,
        save_config,
    )

    args = build_distill_parser().parse_args(argv)
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
    if args.method == "progressive":
        return _progressive_rounds(args, diffusion, dataset, loader, log_dir)

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


def _progressive_rounds(args, diffusion, dataset, loader, log_dir) -> str:
    """The halving rounds of ``distill --method progressive``
    (cli.py:600-636). The loaded module is the student throughout: each
    round freezes a copy of its weights as that round's teacher and trains
    it in place."""
    from dadiff_tpu_torch.models.progressive import (
        make_pd_loss,
        pd_round_schedule,
    )
    from dadiff_tpu_torch.utils.training import Trainer

    rounds = pd_round_schedule(diffusion.n_timesteps, args.target_steps)
    print(f"progressive rounds (steps): {rounds}")
    for r, steps in enumerate(rounds):
        round_dir = log_dir / f"round_{r}_steps{steps}"
        round_dir.mkdir(parents=True, exist_ok=True)
        teacher = {n: p.detach().clone()
                   for n, p in diffusion.named_parameters()}
        trainer = Trainer(
            diffusion, loader, make_pd_loss(diffusion, teacher, steps),
            lr=args.lr, warmup_steps=args.warmup_steps,
            total_steps=args.n_epochs * len(loader),
            gradient_clip=args.gradient_clip, use_ema=False,
            log_dir=str(round_dir), save_freq=args.save_freq, eval_freq=0,
            log_freq=args.log_freq, loss_names=["progressive"],
            seed=args.seed + r, normalizer=dataset.normalizer,
            extra_config={"progressive": True,
                          "progressive_steps": int(steps),
                          "teacher_checkpoint": args.checkpoint})
        print(f"[pd round {r}] distilling to {steps} steps "
              f"({args.n_epochs} epochs)...")
        try:
            trainer.train(args.n_epochs, max_steps=args.max_steps)
        finally:
            trainer.close()
    print(f"Progressive distillation complete ({rounds[-1]}-step student). "
          f"Evaluate with --sampler ddim --sampling-timesteps {rounds[-1]}. "
          f"Logs: {log_dir}")
    return str(log_dir)


def build_value_parser() -> argparse.ArgumentParser:
    """The JAX value-training flags (cli.py:358-380); ``--device`` is cuda
    or cpu and ``--max-steps`` bounds a run."""
    p = argparse.ArgumentParser(
        description="Train a trajectory value function", allow_abbrev=False)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--normalizer", type=str, default="LimitsNormalizer")
    p.add_argument("--discount", type=float, default=0.99)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--dim-mults", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--n-timesteps", type=int, default=100,
                   help="diffusion schedule the value net is trained against")
    p.add_argument("--beta-schedule", type=str, default="cosine")
    p.add_argument("--n-epochs", type=int, default=50)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps, whatever the epoch")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--log-dir", type=str, default="./logs/values")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--reward", type=str, default="recorded",
                   choices=["recorded", "goal-dense"],
                   help="value target reward: the recorded env reward, or "
                        "the dense negative goal distance of goal-concat "
                        "maze observations")
    return p


def goal_dense_reward(ep) -> np.ndarray:
    """r_t = -||pos_{t+1} - goal|| of the goal-concat maze observation
    layout [x y vx vy gx gy] (cli.py:400-414)."""
    obs = np.asarray(ep["observations"], dtype=np.float64)
    if obs.shape[-1] != 6:
        raise SystemExit(
            "--reward goal-dense assumes the goal-concat maze observation "
            f"layout [x y vx vy gx gy] (6 dims); got {obs.shape[-1]} dims — "
            "use --reward recorded for this dataset")
    T = len(ep["actions"])
    nxt = obs[1:T + 1] if len(obs) > T else obs[:T]
    return -np.linalg.norm(nxt[:, 0:2] - nxt[:, 4:6], axis=-1)


def train_value_main(argv=None) -> str:
    """Train the value net on the dataset's discounted returns-to-go under
    the diffusion noise of ``--n-timesteps``/``--beta-schedule`` with Adam
    (cli.py:358-460); returns the written ``value_final.pt``: the state
    dict and the JAX checkpoint's config keys, with ``loss_series``."""
    from dadiff_tpu_torch.datasets.sequence import (
        SequenceDataset,
        create_dataloader,
        prefetch_to_device,
    )
    from dadiff_tpu_torch.models.value_net import ValueNet, value_loss
    from dadiff_tpu_torch.ops.schedules import make_schedule

    args = build_value_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    dataset = SequenceDataset(
        dataset_name=args.dataset, horizon=args.horizon,
        normalizer=args.normalizer, include_returns=True,
        discount=args.discount,
        reward_fn=goal_dense_reward if args.reward == "goal-dense" else None)
    loader = create_dataloader(dataset, batch_size=args.batch_size,
                               seed=args.seed)
    schedule = make_schedule(args.n_timesteps, args.beta_schedule, device)
    vnet = ValueNet(dataset.transition_dim, dim=args.dim,
                    dim_mults=tuple(args.dim_mults)).to(device)
    opt = torch.optim.Adam(vnet.parameters(), lr=args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    series, step = [], 0
    for epoch in range(args.n_epochs):
        losses = []
        for batch in prefetch_to_device(iter(loader), device):
            x0 = batch["conditions"]
            t = torch.randint(0, args.n_timesteps, (x0.shape[0],),
                              generator=gen, device=device)
            noise = torch.randn(x0.shape, generator=gen, device=device)
            loss = value_loss(vnet, schedule, batch, t, noise)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            step += 1
            if args.max_steps is not None and step >= args.max_steps:
                break
        series.append(float(torch.stack(losses).mean()))
        print(f"Epoch {epoch + 1}: value_loss={series[-1]:.4f}")
        if args.max_steps is not None and step >= args.max_steps:
            break
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "value_final.pt"
    torch.save({
        "state_dict": {k: v.detach().cpu() for k, v in
                       vnet.state_dict().items()},
        "config": {
            "transition_dim": dataset.transition_dim, "dim": args.dim,
            "dim_mults": list(args.dim_mults), "horizon": args.horizon,
            "n_timesteps": args.n_timesteps,
            "beta_schedule": args.beta_schedule,
            "returns_mean": dataset.returns_mean,
            "returns_std": dataset.returns_std},
        "steps": step, "loss_series": series}, path)
    print(f"value checkpoint: {path}")
    return str(path)


def load_value_checkpoint(path: str, device="cuda", expect_schedule=None):
    """The ValueNet of a ``train_value_main`` checkpoint, loaded with
    ``strict=True`` on ``device``, its weights frozen (cli.py:463-500).
    ``expect_schedule``: the (n_timesteps, beta_schedule) of the planner it
    will guide; a mismatch exits, since the guidance would read noise levels
    the net never saw. It unpickles: load only trusted checkpoints."""
    from dadiff_tpu_torch.models.value_net import ValueNet

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = ckpt["config"]
    if expect_schedule is not None:
        want_t, want_beta = expect_schedule
        got_t, got_beta = cfg.get("n_timesteps"), cfg.get("beta_schedule")
        if (got_t is not None and got_t != want_t) or (
                got_beta is not None and got_beta != want_beta):
            raise SystemExit(
                f"value checkpoint was trained on schedule (T={got_t}, "
                f"{got_beta}) but the planner uses (T={want_t}, "
                f"{want_beta}); retrain the value net with matching "
                f"--n-timesteps/--beta-schedule")
    vnet = ValueNet(cfg["transition_dim"], dim=cfg["dim"],
                    dim_mults=tuple(cfg["dim_mults"]))
    vnet.load_state_dict(ckpt["state_dict"], strict=True)
    return vnet.to(device).eval().requires_grad_(False)


def build_eval_parser() -> argparse.ArgumentParser:
    """The JAX eval parser's flags, defaults and choices (cli.py:695-800),
    but for ``--device`` (cuda or cpu), ``--render`` (none only: the card's
    machine has no display) and ``--video-dir``, which goes with it and
    argparse refuses."""
    p = argparse.ArgumentParser(
        description="Plan with a diffusion planner", allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--env", type=str, default="PointMaze_UMaze-v3")
    p.add_argument("--policy-type", type=str, default="mpc",
                   choices=["guided", "mpc", "dynamics-aware", "value-guided"])
    p.add_argument("--action-horizon", type=int, default=16)
    p.add_argument("--value-checkpoint", type=str, default=None,
                   help="value-net checkpoint (.pt of python -m "
                        "dadiff_tpu_torch.train_values) for value-guided, or "
                        "stacked on dynamics-aware")
    p.add_argument("--guide-weight", type=float, default=1.0)
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
    p.add_argument("--action-source", type=str, default="plan",
                   choices=["plan", "inverse-dynamics", "track"],
                   help="execute the plan's action columns; derive actions "
                        "from consecutive planned states via a learned "
                        "inverse-dynamics model fitted to --dataset "
                        "(Decision-Diffuser-style, open-loop); or 'track': "
                        "each action computed at execution time from the "
                        "OBSERVED state toward the planned next state, "
                        "u_t = g(s_obs, s_plan_next)")
    p.add_argument("--candidate-scorer", type=str, default="goal",
                   choices=["goal", "velocity", "wall-penalty"],
                   help="best-of-N plan scorer: final goal distance (maze), "
                        "negative mean planned forward velocity "
                        "(locomotion), or goal distance + wall-collision "
                        "penalty; --megakernel selects by goal distance only")
    p.add_argument("--wall-penalty-weight", type=float, default=5.0,
                   help="penalty per fully-in-wall plan for "
                        "--candidate-scorer wall-penalty")
    p.add_argument("--skip-conditioned-action", action="store_true",
                   help="start the action buffer at row 1: row 0's action "
                        "is the one the conditioning zeroed")
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
    p.add_argument("--mega-group-chains", type=int, default=64,
                   help="chains per group of the planner chain's wave")
    p.add_argument("--replan-deviation", type=float, default=None,
                   help="replan early when the executed observation drifts "
                        "more than this L2 distance (normalized space) from "
                        "the plan row it should be on (sequential protocol "
                        "only)")
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
    """Rebuild the GaussianDiffusion of a loaded checkpoint (a U-Net, or the
    transformer its config's ``model_type`` names) from its weight shapes
    and stored flags, and load it with
    ``strict=True`` (on the CPU): ``ema_state_dict`` if ``use_ema`` and the
    checkpoint has one, else ``model_state_dict`` (cli.py:912)."""
    from dadiff_tpu_torch.io.torch_compat import (
        infer_model_config_from_checkpoint,
    )
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion

    cfg = infer_model_config_from_checkpoint(checkpoint)
    saved = checkpoint.get("config", {}) or {}
    for key in ("predict_epsilon", "clip_denoised", "prediction"):
        if key in saved:
            cfg[key] = saved[key]
    denoiser = build_denoiser(
        cfg["model_type"], observation_dim + action_dim, dim=cfg["dim"],
        dim_mults=cfg["dim_mults"], depth=cfg.get("depth", 4),
        n_heads=cfg.get("n_heads", 4), mlp_ratio=cfg.get("mlp_ratio", 4))
    diffusion = GaussianDiffusion(
        denoiser, horizon=horizon, observation_dim=observation_dim,
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


def _candidate_scorer(args, dataset):
    """The best-of-N scorer ``--candidate-scorer`` names; None for the
    policy's default, the goal distance (cli.py:1009-1025)."""
    from dadiff_tpu_torch.guides import policies

    if args.candidate_scorer == "velocity":
        return policies.velocity_scorer_for_env(args.env)
    if args.candidate_scorer == "wall-penalty":
        grid = maze_grid_for_env(args.env)
        if grid is None:
            raise SystemExit(
                f"--candidate-scorer wall-penalty: no maze map for {args.env}")
        return policies.make_wall_penalty_scorer(
            dataset.normalizer.obs_mean, dataset.normalizer.obs_std, grid,
            penalty=args.wall_penalty_weight)
    return None


def _value_guide(args, diffusion):
    """guide_fn of ``--value-checkpoint``, refused on another schedule."""
    from dadiff_tpu_torch.models.value_net import make_value_guide_fn

    vnet = load_value_checkpoint(
        args.value_checkpoint, device=diffusion.device,
        expect_schedule=(diffusion.n_timesteps, diffusion.beta_schedule))
    return make_value_guide_fn(vnet)


def build_policy_from_args(args, diffusion, dataset, dataset_spec: str,
                           sampling_timesteps: int):
    """The policy an eval-parser namespace describes (cli.py:1002-1158):
    guided, mpc, value-guided or dynamics-aware (optionally with value
    guidance stacked on its projection), wired to the planner chain with
    ``--megakernel``, which raises for a sampler other than ddpm, for warm
    start, for guidance and for a scorer other than the goal distance (the
    wave selects by goal distance itself). ``--action-source
    inverse-dynamics|track`` fits an inverse-dynamics model to the dataset
    (envs/learned_model.py, on the planner's device) and hands it to the
    policy (cli.py:1020-1032)."""
    from dadiff_tpu_torch.guides import policies

    if args.megakernel and args.candidate_scorer != "goal":
        raise ValueError(
            f"--megakernel selects the best candidate by goal distance "
            f"inside the wave; --candidate-scorer {args.candidate_scorer} "
            f"needs the module path (drop --megakernel)")
    inverse_dynamics = None
    if args.action_source in ("inverse-dynamics", "track"):
        from dadiff_tpu_torch.datasets.sources import load_episodes
        from dadiff_tpu_torch.envs.learned_model import (
            train_inverse_dynamics,
        )

        print("fitting inverse-dynamics model on the dataset ...")
        inverse_dynamics, inv_metrics = train_inverse_dynamics(
            load_episodes(dataset_spec), seed=args.seed,
            device=diffusion.device)
        print(f"inverse-dynamics held-out action R^2: "
              f"mean={inv_metrics['r2_mean']:.4f} "
              f"min={inv_metrics['r2_min']:.4f}")
    common = dict(
        sampling_timesteps=sampling_timesteps, seed=args.seed,
        skip_conditioned_action=args.skip_conditioned_action,
        candidate_scorer=_candidate_scorer(args, dataset),
        inverse_dynamics=inverse_dynamics,
        track_planned_states=args.action_source == "track",
        warm_start_t=args.warm_start_t,
        warm_start_auto=args.warm_start_auto,
        replan_deviation=args.replan_deviation)
    sampling = dict(n_candidates=args.n_candidates, sampler=args.sampler)
    if args.policy_type == "guided":
        policy = policies.GuidedPolicy(diffusion, dataset.normalizer,
                                       **common, **sampling)
    elif args.policy_type == "mpc":
        policy = policies.MPCPolicy(diffusion, dataset.normalizer,
                                    action_horizon=args.action_horizon,
                                    **common, **sampling)
    elif args.policy_type == "value-guided":
        if not args.value_checkpoint:
            raise SystemExit("value-guided requires --value-checkpoint")
        # one candidate, the ddpm sampler, as the JAX CLI builds it
        policy = policies.ValueGuidedPolicy(
            diffusion, dataset.normalizer,
            trajectory_value_fn=_value_guide(args, diffusion),
            guide_weight=args.guide_weight,
            action_horizon=args.action_horizon, **common)
    else:  # dynamics-aware
        from dadiff_tpu_torch.datasets.sources import load_episodes
        from dadiff_tpu_torch.dynamics.projection import (
            ProjectionMatrixBuilder,
        )
        from dadiff_tpu_torch.dynamics.registry import get_dynamics_for_env

        A, B, state_dim, action_dim = get_dynamics_for_env(
            args.env, episodes=load_episodes(dataset_spec))
        P = ProjectionMatrixBuilder(A, B, state_dim, action_dim
                                    ).get_projection_matrix(diffusion.horizon)
        wall_grid = None
        if args.wall_aware:
            wall_grid = maze_grid_for_env(args.env)
            if wall_grid is None:
                raise SystemExit(f"--wall-aware: no maze map for {args.env}")
        guide_fn, guide_weight = None, 0.0
        if args.value_checkpoint:
            guide_fn, guide_weight = (_value_guide(args, diffusion),
                                      args.guide_weight)
        policy = policies.DynamicsAwarePolicy(
            diffusion, projection_matrix=P, normalizer=dataset.normalizer,
            state_dim=state_dim, projection_schedule=args.projection_schedule,
            projection_strength=args.projection_strength,
            action_horizon=args.action_horizon, parity_mode=args.parity_mode,
            wall_grid=wall_grid, wall_margin=args.wall_margin,
            guide_fn=guide_fn, guide_weight=guide_weight, **common,
            **sampling)
    if args.megakernel:
        from dadiff_tpu_torch.ops.planner import wire_policy_megakernel

        wire_policy_megakernel(policy, n_candidates=args.n_candidates,
                               group_chains=args.mega_group_chains)
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
    ``--sampler``, build the ``--policy-type`` policy, run the sequential
    protocol or, with ``--batched``, all episodes in lockstep, and write the
    timestamped results JSON with the JAX package's keys. Returns the
    metrics."""
    args = build_eval_parser().parse_args(argv)
    if args.replan_deviation is not None and args.batched:
        raise SystemExit(
            "--replan-deviation needs the sequential protocol (drop --batched):"
            " lockstep waves cannot replan per-env")
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
            # the JAX package's provenance keys
            "sampler": args.sampler,
            "n_candidates": args.n_candidates,
            "candidate_scorer": args.candidate_scorer,
            "wall_penalty_weight": (args.wall_penalty_weight
                                    if args.candidate_scorer == "wall-penalty"
                                    else None),
            "action_source": args.action_source,
            "batched": args.batched,
            "wall_aware": args.wall_aware,
            "wall_margin": args.wall_margin,
            "parity_mode": args.parity_mode,
            "projection_schedule": args.projection_schedule,
            "projection_strength": args.projection_strength,
            "action_horizon": args.action_horizon,
            "warm_start_t": args.warm_start_t,
            "replan_deviation": args.replan_deviation,
            "guide_weight": (args.guide_weight if args.value_checkpoint
                             else None),
            "value_checkpoint": args.value_checkpoint,
            "use_ema": args.use_ema,
        })
    print(f"Mean reward: {metrics['mean_reward']:.2f} ± "
          f"{metrics['std_reward']:.2f}")
    print(f"Mean length: {metrics['mean_length']:.2f} "
          f"success rate: {metrics['success_rate']:.2f}")
    print(f"Results: {path}")
    return metrics
