"""Training infrastructure: the train step, EMA, LR schedule, Trainer and
checkpointing.

Counterpart of the JAX package's utils/training.py: warmup_cosine_schedule :34,
EMA :55, ema_update :69, TrainState :79, make_optimizer :86, make_train_step
:97, Trainer :171, count_parameters :485, save_config :490, load_config :496
and create_trainer_with_custom_loss :502. The JAX step is one jitted program
over an immutable state; here the weights live in the diffusion module and
Adam's moments in the optimizer, and the step updates both in place.

The optimizer is optax's chain: clip by global norm, then Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8 added to the root, no weight decay), the
learning rate read from the schedule at the count of updates applied so far.

With ``loss_takes_ema`` the loss also receives the EMA shadow, which then
serves as the stop-gradient target network of consistency distillation
(models/consistency.py).

With a mesh (``Trainer(mesh=)``, training.py:179 and :254-258), every rank
loads the same global batch and trains on its block of rows over ``dp``,
drawing the loss's ``t`` and noise for the global batch
(parallel/mesh.py ``batch_rows``): DDP averages the gradients over dp, or,
with ``fsdp_axis``, FSDP2 shards the weights and Adam's moments over that
axis. Only rank 0 logs and writes files; its ``.pt`` and ``.train.pt`` hold
whole tensors: the ``.pt`` loads with ``strict=True`` into a single-device
module, and any run, sharded or not, resumes from the ``.train.pt``.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dadiff_tpu_torch.datasets.sequence import prefetch_to_device
from dadiff_tpu_torch.losses import make_generators
from dadiff_tpu_torch.parallel.distributed import is_primary_host
from dadiff_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    batch_rows,
    full_state_dict,
    full_tensor,
    local_rows,
    place_like,
    shard_params_fsdp,
)
from dadiff_tpu_torch.utils.debug import all_finite


# ---------------------------------------------------------------------------
# LR schedule and EMA
# ---------------------------------------------------------------------------

def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup then cosine decay, lr = base*scale + min_lr*(1-scale)
    (training.py:34-48)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            scale = step / max(warmup_steps, 1)
        else:
            progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
            scale = 0.5 * (1.0 + math.cos(math.pi * min(max(progress, 0.0), 1.0)))
        return base_lr * scale + min_lr * (1.0 - scale)

    return schedule


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    """shadow = decay*shadow + (1-decay)*param, in place (training.py:69-72)."""
    names = list(shadow)
    torch._foreach_mul_([shadow[n] for n in names], decay)
    torch._foreach_add_([shadow[n] for n in names],
                        [params[n].detach() for n in names], alpha=1.0 - decay)
    return shadow


class EMA:
    """Shadow-parameter EMA of a module's parameters (training.py:55-66)."""

    def __init__(self, module: torch.nn.Module, decay: float = 0.995):
        self.decay = decay
        self.module = module
        self.shadow = {n: p.detach().clone()
                       for n, p in module.named_parameters()}

    def update(self):
        return ema_update(self.shadow, dict(self.module.named_parameters()),
                          self.decay)


# ---------------------------------------------------------------------------
# Train state + step
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """What a step carries (training.py:79-83): ``step`` counts every step,
    ``n_updates`` the updates Adam applied (a skipped non-finite batch
    advances the first only); the weights are ``module``'s parameters and
    Adam's moments live in ``optimizer``."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]
    step: int = 0
    n_updates: int = 0


def make_optimizer(params, lr: float = 3e-4) -> torch.optim.Adam:
    """Adam with optax's defaults (training.py:86-94). The global-norm clip
    that optax chains in front of it is applied by the train step, which
    also reports the unclipped norm."""
    return torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def make_train_step(loss_fn: Callable, *, lr_schedule: Callable[[int], float],
                    gradient_clip: float = 1.0, use_ema: bool = True,
                    ema_decay: float = 0.995, skip_nonfinite: bool = False,
                    loss_takes_ema: bool = False,
                    after_backward: Optional[Callable[[], None]] = None):
    """Build ``step(state, batch, generators) -> metrics``: loss, grad, clip,
    Adam, EMA (training.py:97-164). Metrics are 0-dim tensors on the device
    (no host sync), with ``grad_norm`` the global norm before clipping.
    With ``loss_takes_ema`` the loss is called as ``loss_fn(batch,
    generators, state.ema_params)``, the EMA shadow before this step's
    update (training.py:115-125); it needs ``use_ema``.

    With ``skip_nonfinite``, a batch whose gradients are not all finite
    leaves the parameters AND Adam's moments and step count untouched and
    reports ``nonfinite=1``; the EMA and ``state.step`` still advance, as in
    the JAX step. Deciding that costs one host sync per step.

    Under FSDP or tp (DTensor gradients) the norm is the whole model's,
    reduced over the shards, so every rank clips by the same factor.
    ``after_backward()`` runs between the backward and the norm (a tp/sp
    model averages its gradients over dp there: parallel/tp.py
    ``average_grads``).
    """
    if loss_takes_ema and not use_ema:
        raise ValueError("loss_takes_ema requires use_ema=True")

    def step(state: TrainState, batch, generators=None):
        params = [p for p in state.module.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        if loss_takes_ema:
            loss, metrics = loss_fn(batch, generators, state.ema_params)
        else:
            loss, metrics = loss_fn(batch, generators)
        loss.backward()
        if after_backward is not None:
            after_backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = [p.grad for p in params]
        grad_norm = full_tensor(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))
        apply = True
        if skip_nonfinite:
            finite = all_finite(grads)
            metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
            apply = bool(finite)
        if apply:
            if gradient_clip and gradient_clip > 0:
                # optax.clip_by_global_norm: g * clip / norm when norm > clip
                scale = torch.where(grad_norm > gradient_clip,
                                    gradient_clip / grad_norm,
                                    torch.ones_like(grad_norm))
                torch._foreach_mul_(grads, scale)
            lr = lr_schedule(state.n_updates)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.n_updates += 1
        if use_ema and state.ema_params is not None:
            ema_update(state.ema_params,
                       dict(state.module.named_parameters()), ema_decay)
        metrics["grad_norm"] = grad_norm
        state.step += 1
        return metrics

    return step


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Epoch-driven trainer with logging and checkpointing
    (training.py:171-482).

    Args:
        diffusion: the GaussianDiffusion module to train, already on its
            device; its parameters are updated in place.
        train_loader: sized, re-iterable loader of ``{'conditions':
            (B, H, D)}`` numpy batches (datasets.create_dataloader).
        loss_fn: ``(batch, generators) -> (loss, metrics)``, e.g. the
            objective of losses.build_loss over ``diffusion``; with
            ``loss_takes_ema``, ``(batch, generators, ema_params)``.
        extra_config: written into the checkpoints' config (e.g. the
            consistency student's ``consistency: true``).
        mesh: a ``DeviceMesh`` with a ``dp`` axis (parallel/mesh.py
            ``make_mesh``): each rank trains on its block of every batch,
            which the axis must divide, and DDP averages the gradients over
            dp. The module's replicas start from rank 0's weights.
        fsdp_axis: with a mesh, shard the denoiser's weights over this axis
            with FSDP2 (``shard_params_fsdp``) instead of DDP. The port's
            own option (JAX's Trainer replicates the weights; its FSDP step
            lives in ``dryrun_multichip``), set by no CLI flag. Its
            ``.pt`` and ``.train.pt`` hold whole tensors, Adam's moments
            included, so they are the files an unsharded run writes: an
            FSDP run resumes from an unsharded run's checkpoint and the
            other way round.
    """

    def __init__(self, diffusion, train_loader, loss_fn: Callable, *,
                 lr: float = 3e-4, warmup_steps: int = 0,
                 total_steps: Optional[int] = None, gradient_clip: float = 1.0,
                 use_ema: bool = True, ema_decay: float = 0.995,
                 log_dir: str = "./logs", save_freq: int = 10000,
                 eval_freq: int = 5000, log_freq: int = 50,
                 loss_names: Optional[List[str]] = None, seed: int = 0,
                 export_pt: bool = True, skip_nonfinite: bool = False,
                 val_batch=None, normalizer=None,
                 loss_takes_ema: bool = False,
                 extra_config: Optional[Dict[str, Any]] = None,
                 mesh=None, fsdp_axis: Optional[str] = None):
        if not hasattr(train_loader, "__len__"):
            raise TypeError(
                "train_loader must be a sized, re-iterable loader (e.g. "
                "datasets.create_dataloader): a one-shot generator would "
                "silently yield zero-step epochs after the first")
        self.diffusion = diffusion
        self.device = diffusion.device
        self.train_loader = train_loader
        self.loss_fn = loss_fn
        self.log_dir = log_dir
        self.save_freq = save_freq
        self.eval_freq = eval_freq
        self.log_freq = log_freq
        self.use_ema = use_ema
        self.loss_names = loss_names or ["diffusion"]
        self.export_pt = export_pt
        self.normalizer = normalizer
        self.extra_config = dict(extra_config) if extra_config else {}
        self.mesh = mesh
        self.primary = is_primary_host()

        self._log_file = self._metrics_file = None
        if self.primary:
            os.makedirs(log_dir, exist_ok=True)
            self._log_file = open(os.path.join(log_dir, "training.log"), "a")
            self._metrics_file = open(os.path.join(log_dir, "metrics.jsonl"),
                                      "a")

        # one generator per loss component, one more for the val probe
        self.generators = make_generators(len(self.loss_names) + 1, seed,
                                          self.device)
        total_steps = total_steps or (len(train_loader) * 100)
        self.lr_schedule = warmup_cosine_schedule(lr, warmup_steps, total_steps)
        objective = loss_fn
        if mesh is not None and fsdp_axis is not None:
            shard_params_fsdp(diffusion.model, mesh, axis=fsdp_axis)
        elif mesh is not None:
            from torch.nn.parallel import DistributedDataParallel

            objective = DistributedDataParallel(
                _Objective(diffusion, loss_fn),
                device_ids=([self.device.index]
                            if self.device.type == "cuda" else None),
                process_group=mesh.get_group("dp"))
        self.state = TrainState(
            module=diffusion,
            optimizer=make_optimizer(diffusion.parameters(), lr),
            ema_params=EMA(diffusion, ema_decay).shadow if use_ema else None)
        self._train_step = make_train_step(
            objective, lr_schedule=self.lr_schedule,
            gradient_clip=gradient_clip,
            use_ema=use_ema, ema_decay=ema_decay, skip_nonfinite=skip_nonfinite,
            loss_takes_ema=loss_takes_ema)
        self.global_step = 0
        self._val_batch = None
        if val_batch is not None:
            self._val_batch = {k: torch.as_tensor(v).to(self.device)
                               for k, v in val_batch.items()}

    @torch.no_grad()
    def evaluate(self, use_ema: bool = False) -> Optional[float]:
        """Held-out loss on the validation batch (None if not configured)."""
        if self._val_batch is None:
            return None
        gens = [self.generators[-1]] * len(self.loss_names)
        if not (use_ema and self.state.ema_params is not None):
            return float(self.loss_fn(self._val_batch, gens)[0])
        live = {n: p.detach().clone()
                for n, p in self.diffusion.named_parameters()}
        try:
            for n, p in self.diffusion.named_parameters():
                p.copy_(self.state.ema_params[n])
            return float(self.loss_fn(self._val_batch, gens)[0])
        finally:
            for n, p in self.diffusion.named_parameters():
                p.copy_(live[n])

    # -- core loop ------------------------------------------------------------
    def _step(self, batch):
        """One step on this rank's rows, already on the device; the metrics
        stay on the device."""
        with batch_rows(self.mesh):
            metrics = self._train_step(self.state, batch,
                                       self.generators[:len(self.loss_names)])
        self.global_step = self.state.step
        return metrics

    def train_step(self, batch) -> Dict[str, float]:
        """One step on this rank's rows of a batch already on the device;
        host metrics, averaged over dp."""
        metrics = all_reduce_mean(self._step(batch), self.mesh)
        return {k: float(v) for k, v in metrics.items()}

    def _write(self, line: Optional[str] = None,
               record: Optional[Dict[str, Any]] = None) -> None:
        """Rank 0's log line and metrics record."""
        if not self.primary:
            return
        if line is not None:
            print(line)
            self._log_file.write(line + "\n")
            self._log_file.flush()
        if record is not None:
            self._metrics_file.write(json.dumps(record) + "\n")
            self._metrics_file.flush()

    def train(self, n_epochs: int, start_epoch: int = 0,
              max_steps: Optional[int] = None) -> Dict[str, List[float]]:
        """Main loop (training.py:297-353); returns the loss history by
        epoch. ``max_steps`` ends the run early after that many steps."""
        history: Dict[str, List[float]] = {}
        done = 0
        epoch = start_epoch + n_epochs - 1
        self.diffusion.train()
        for epoch in range(start_epoch, start_epoch + n_epochs):
            epoch_metrics: Dict[str, List[float]] = {}
            t0 = time.time()
            n_steps = 0
            rows = (local_rows(b, self.mesh) for b in iter(self.train_loader))
            for batch in prefetch_to_device(rows, self.device, size=2):
                metrics = self._step(batch)
                n_steps += 1
                done += 1
                if n_steps == 1 or (self.log_freq
                                    and n_steps % self.log_freq == 0):
                    metrics = all_reduce_mean(metrics, self.mesh)
                    for k, v in metrics.items():
                        epoch_metrics.setdefault(k, []).append(float(v))
                if self.save_freq and self.global_step % self.save_freq == 0:
                    self.save_checkpoint(epoch)
                if (self._val_batch is not None and self.eval_freq
                        and self.global_step % self.eval_freq == 0):
                    epoch_metrics.setdefault("val_loss", []).append(
                        self.evaluate())
                    self.diffusion.train()
                if max_steps is not None and done >= max_steps:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            sps = n_steps / max(time.time() - t0, 1e-9)
            summary = {k: float(np.mean(v)) for k, v in epoch_metrics.items()
                       if v}
            line = (f"Epoch {epoch + 1}: "
                    + " ".join(f"{k}={v:.4f}" for k, v in summary.items())
                    + f" steps/s={sps:.2f}")
            self._write(line, {
                "epoch": epoch + 1, "step": self.state.step,
                "steps_per_sec": round(sps, 3),
                **{k: round(v, 6) for k, v in summary.items()},
                # the logged values of the objective behind the epoch's
                # mean, first to last ("total", or the one loss's own name)
                "total_series": [round(v, 6) for v in epoch_metrics.get(
                    "total", epoch_metrics.get(self.loss_names[0], []))],
            })
            for k, v in summary.items():
                history.setdefault(k, []).append(v)
            if max_steps is not None and done >= max_steps:
                break
        self.diffusion.eval()
        self.save_checkpoint(epoch, final=True)
        return history

    def close(self) -> None:
        for f in (self._log_file, self._metrics_file):
            if f is not None:
                f.close()

    # -- checkpointing --------------------------------------------------------
    def _config_dict(self) -> Dict[str, Any]:
        d = self.diffusion
        cfg = {
            "horizon": d.horizon, "observation_dim": d.observation_dim,
            "action_dim": d.action_dim, "n_timesteps": d.n_timesteps,
            "beta_schedule": d.beta_schedule, "dim": d.model.dim,
            "dim_mults": list(d.model.dim_mults),
            "predict_epsilon": d.predict_epsilon,
            "clip_denoised": d.clip_denoised,
        }
        if d.prediction:
            cfg["prediction"] = d.prediction
        # the second model family records its type and its own widths, so
        # that load_model rebuilds it (training.py:380-391)
        model_type = type(d.model).__name__
        if model_type != "TemporalUnet":
            cfg["model_type"] = ("transformer"
                                 if model_type == "TemporalTransformer"
                                 else model_type)
            for key in ("depth", "n_heads", "mlp_ratio"):
                if hasattr(d.model, key):
                    cfg[key] = int(getattr(d.model, key))
        if self.normalizer is not None and hasattr(self.normalizer, "as_arrays"):
            cfg["normalizer_name"] = getattr(self.normalizer,
                                             "normalizer_name", "stored")
            cfg["normalizer_stats"] = {
                k: np.asarray(v).tolist()
                for k, v in self.normalizer.as_arrays().items()}
        cfg.update(self.extra_config)
        return cfg

    def save_checkpoint(self, epoch: int, final: bool = False) -> str:
        """Write ``checkpoint_step_N.train.pt`` (the full train state, for
        resume) and, with ``export_pt``, the reference-schema
        ``checkpoint_step_N.pt`` that ``cli.load_model`` and the server read
        (training.py:406-446). Returns the path without extension. Under a
        mesh every rank calls it (FSDP gathers the weights and Adam's
        moments) and rank 0 writes."""
        self.global_step = self.state.step
        base = os.path.join(self.log_dir, f"checkpoint_step_{self.global_step}")
        model_state = full_state_dict(self.diffusion.state_dict())
        ema = (None if self.state.ema_params is None
               else full_state_dict(self.state.ema_params))
        optimizer_state = self.state.optimizer.state_dict()
        optimizer_state["state"] = {
            i: full_state_dict(s) for i, s in optimizer_state["state"].items()}
        if not self.primary:
            return base
        config = self._config_dict()
        torch.save({
            "step": self.state.step, "n_updates": self.state.n_updates,
            "epoch": epoch, "config": config,
            "model_state_dict": model_state,
            "optimizer_state_dict": optimizer_state,
            "ema_params": ema,
            "generator_states": [g.get_state() for g in self.generators],
        }, base + ".train.pt")
        if self.export_pt:
            from dadiff_tpu_torch.io.torch_compat import save_pt_checkpoint

            save_pt_checkpoint(base + ".pt", self.diffusion, config,
                               ema_params=ema, epoch=epoch,
                               global_step=self.global_step,
                               model_state=model_state)
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
        return base

    def load_latest(self, log_dir: Optional[str] = None) -> Optional[int]:
        """Restore the highest-step train state in ``log_dir`` (None if there
        is none); returns its epoch (training.py:448-464)."""
        log_dir = log_dir or self.log_dir
        candidates = []
        for path in glob.glob(os.path.join(log_dir,
                                           "checkpoint_step_*.train.pt")):
            m = re.search(r"checkpoint_step_(\d+)\.train\.pt$", path)
            if m:
                candidates.append((int(m.group(1)), path[:-len(".train.pt")]))
        if not candidates:
            return None
        return self.load_checkpoint(max(candidates)[1])

    def load_checkpoint(self, path: str, reset_optimizer: bool = False) -> int:
        """Restore a train state written by :meth:`save_checkpoint` (path
        without extension); returns the stored epoch. The file holds whole
        tensors; under FSDP each rank keeps its shards of them. It
        unpickles: load only checkpoints this program wrote
        (training.py:466-482)."""
        ck = torch.load(path + ".train.pt", map_location=self.device,
                        weights_only=False)
        current = self.diffusion.state_dict()
        self.diffusion.load_state_dict(
            {k: place_like(v, current[k])
             for k, v in ck["model_state_dict"].items()}, strict=True)
        if ck["ema_params"] is not None and self.state.ema_params is not None:
            for n, v in ck["ema_params"].items():
                shadow = self.state.ema_params[n]
                shadow.copy_(place_like(v, shadow))
        if reset_optimizer:
            self.state.optimizer = make_optimizer(self.diffusion.parameters())
            self.state.step = self.state.n_updates = 0
        else:
            params = [p for g in self.state.optimizer.param_groups
                      for p in g["params"]]
            optimizer_state = dict(ck["optimizer_state_dict"])
            optimizer_state["state"] = {
                i: {k: (place_like(v, params[i])
                        if torch.is_tensor(v) and v.shape == params[i].shape
                        else v) for k, v in s.items()}
                for i, s in optimizer_state["state"].items()}
            self.state.optimizer.load_state_dict(optimizer_state)
            self.state.step, self.state.n_updates = ck["step"], ck["n_updates"]
            for g, s in zip(self.generators, ck["generator_states"]):
                g.set_state(s.cpu())
        self.global_step = self.state.step
        return int(ck.get("epoch", 0))


class _Objective(torch.nn.Module):
    """The loss as a module that owns the diffusion's parameters, so that
    DDP's forward wraps the whole objective, whatever it calls inside (the
    denoiser once, or the student and its target), and its reducer averages
    every gradient over dp in the backward."""

    def __init__(self, diffusion: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.diffusion = diffusion
        self.loss_fn = loss_fn

    def forward(self, *args):
        return self.loss_fn(*args)


def create_trainer_with_custom_loss(
        model, train_loader, loss_fn, *, scheduler=None, device=None,
        log_dir="./logs", save_freq=10000, eval_freq=5000, use_ema=True,
        ema_decay=0.995, gradient_clip=1.0, loss_names=None, **kwargs):
    """The reference's factory (training.py:502-516): a :class:`Trainer`.
    ``scheduler`` and ``device`` are accepted for its signature and unused:
    the learning rate follows the Trainer's schedule and the module is
    already on its device."""
    del scheduler, device
    return Trainer(model, train_loader, loss_fn, log_dir=log_dir,
                   save_freq=save_freq, eval_freq=eval_freq, use_ema=use_ema,
                   ema_decay=ema_decay, gradient_clip=gradient_clip,
                   loss_names=loss_names, **kwargs)


def count_parameters(module: torch.nn.Module) -> int:
    """Total parameter count (training.py:485-487)."""
    return sum(p.numel() for p in module.parameters())


def save_config(config: Dict[str, Any], save_path: str) -> None:
    with open(save_path, "w") as f:
        json.dump(config, f, indent=4)


def load_config(config_path: str) -> Dict[str, Any]:
    with open(config_path) as f:
        return json.load(f)
