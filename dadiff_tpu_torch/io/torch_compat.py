"""Reference-schema ``.pt`` checkpoints, and weights carried over from the
JAX package.

Counterpart of the JAX package's io/torch_compat.py: unet_key_mapping :58,
infer_model_config_from_checkpoint :202, save_pt_checkpoint :258 and
load_pt_checkpoint :308. The schema is
``{epoch, global_step, model_state_dict, optimizer_state_dict, config,
ema_state_dict?}`` with the denoiser under ``model.`` and the 12 schedule
buffers at the top of ``model_state_dict``.

``params_from_jax`` turns a Flax TemporalUnet parameter tree (as numpy)
into the port's TemporalUnet state dict; ``block_params_from_jax`` one
residual block's dict and ``train_state_from_jax`` an optax Adam state and
EMA tree. Layouts:
  Conv1d          flax (k, in, out) -> torch (out, in, k)
  ConvTranspose1d jax  (k, out, in) -> torch (in, out, k)
  Dense           flax (in, out)    -> torch Linear (out, in)
  GroupNorm       scale/bias        -> weight/bias
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def unet_key_mapping(n_levels: int) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch prefix, flax path, kind) for every TemporalUnet layer
    (torch_compat.py:41-82); torch prefixes are relative to the unet."""

    def res(prefix, name):
        return [
            (f"{prefix}.blocks.0.block.0", (name, "block1", "conv"), "conv"),
            (f"{prefix}.blocks.0.block.1", (name, "block1", "norm"), "norm"),
            (f"{prefix}.blocks.1.block.0", (name, "block2", "conv"), "conv"),
            (f"{prefix}.blocks.1.block.1", (name, "block2", "norm"), "norm"),
            (f"{prefix}.time_mlp.1", (name, "time_dense"), "dense"),
            (f"{prefix}.residual_conv", (name, "residual_conv"), "conv"),
        ]

    table = [
        ("time_mlp.1", ("time_dense1",), "dense"),
        ("time_mlp.3", ("time_dense2",), "dense"),
        ("final_conv.0.block.0", ("final_block", "conv"), "conv"),
        ("final_conv.0.block.1", ("final_block", "norm"), "norm"),
        ("final_conv.1", ("final_conv",), "conv"),
    ]
    for i in range(n_levels):
        table += res(f"downs.{i}.0", f"down_{i}_res1")
        table += res(f"downs.{i}.1", f"down_{i}_res2")
        if i < n_levels - 1:
            table.append((f"downs.{i}.2.conv", (f"down_{i}_downsample",), "conv"))
    table += res("mid_block1", "mid_block1")
    table += res("mid_block2", "mid_block2")
    for i in range(n_levels - 1):
        table += res(f"ups.{i}.0", f"up_{i}_res1")
        table += res(f"ups.{i}.1", f"up_{i}_res2")
        table.append((f"ups.{i}.2.conv", (f"up_{i}_upsample",), "convtranspose"))
    return table


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax TemporalUnet params (nested dicts of numpy arrays) -> the port's
    ``TemporalUnet`` state dict, loadable with ``strict=True``."""
    n_levels = sum(1 for k in params if k.startswith("down_") and k.endswith("_res1"))
    state: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in unet_key_mapping(n_levels):
        node = params
        for p in path:
            node = node.get(p) if isinstance(node, Mapping) else None
            if node is None:
                break
        if node is None:
            continue  # Identity residual when widths match
        if kind == "norm":
            w = np.asarray(node["scale"], np.float32)
        else:
            w = np.asarray(node["kernel"], np.float32)
            w = w.T if kind == "dense" else np.transpose(w, (2, 1, 0))
        state[f"{prefix}.weight"] = torch.tensor(w)
        state[f"{prefix}.bias"] = torch.tensor(np.asarray(node["bias"],
                                                         np.float32))
    return state


def block_params_from_jax(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One Flax ResidualTemporalBlock's params (numpy) -> the dict of
    ops/resblock.py, whose layout is the JAX package's own
    (fused_unet.py:44-58)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    out = {}
    for i, blk in ((1, "block1"), (2, "block2")):
        out[f"w{i}"] = t(p[blk]["conv"]["kernel"])
        out[f"b{i}"] = t(p[blk]["conv"]["bias"])
        out[f"s{i}"] = t(p[blk]["norm"]["scale"])
        out[f"g{i}"] = t(p[blk]["norm"]["bias"])
    if "residual_conv" in p:
        out["wr"] = t(p["residual_conv"]["kernel"][0])
        out["br"] = t(p["residual_conv"]["bias"])
    return out


def train_state_from_jax(state, *, count: int, mu: Dict[str, Any],
                         nu: Dict[str, Any],
                         ema: Optional[Dict[str, Any]] = None) -> None:
    """Carry an optax Adam state (``count``, and ``mu``/``nu`` as Flax
    TemporalUnet trees of numpy) and an EMA tree into a port
    ``TrainState`` whose module is a GaussianDiffusion over a TemporalUnet:
    Adam's moments and step count, ``n_updates``/``step``, and the EMA
    shadow, in place."""
    moments = [params_from_jax(tree) for tree in (mu, nu)]
    for name, p in state.module.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moments[0][name].to(p),
            "exp_avg_sq": moments[1][name].to(p),
        }
    state.step = state.n_updates = int(count)
    if ema is not None:
        for name, v in params_from_jax(ema).items():
            state.ema_params[f"model.{name}"].copy_(v)


def infer_n_levels(model_state: Dict[str, Any]) -> int:
    """Encoder levels from ``model.downs.{i}`` keys (torch_compat.py:190-199)."""
    idx = [int(k.split(".")[2]) for k in model_state
           if k.startswith("model.downs.") and k.split(".")[2].isdigit()]
    return max(idx, default=-1) + 1


def infer_model_config_from_checkpoint(checkpoint: Dict[str, Any]) -> Dict[str, Any]:
    """Architecture from weight shapes (torch_compat.py:202-255)."""
    state = checkpoint["model_state_dict"]
    saved = checkpoint.get("config", {}) or {}
    n_timesteps = (int(state["betas"].shape[0]) if "betas" in state
                   else int(saved.get("n_timesteps", 200)))
    num_levels = infer_n_levels(state)
    key = "model.downs.0.0.blocks.0.block.0.weight"
    dim = int(state[key].shape[0]) if key in state else 128
    mults = [int(state[k].shape[0]) // dim for k in
             (f"model.downs.{i}.0.blocks.0.block.0.weight"
              for i in range(num_levels)) if k in state]
    if mults:
        dim_mults = tuple(mults)
    elif num_levels > 0:
        dim_mults = tuple(2 ** i for i in range(num_levels))
    else:
        dim_mults = (1, 2, 4, 8)
    fkey = "model.final_conv.1.weight"
    return {
        "dim": dim,
        "dim_mults": list(dim_mults),
        "n_timesteps": n_timesteps,
        "beta_schedule": saved.get("beta_schedule", "cosine"),
        "horizon": saved.get("horizon", 16),
        "transition_dim": int(state[fkey].shape[0]) if fkey in state else None,
        "observation_dim": saved.get("observation_dim"),
        "action_dim": saved.get("action_dim"),
    }


_CONFIG_EXTRAS = ("normalizer_name", "normalizer_stats", "predict_epsilon",
                  "clip_denoised", "prediction", "consistency", "sigma_data",
                  "teacher_checkpoint")


def save_pt_checkpoint(path: str, diffusion, config: Dict[str, Any], *,
                       ema_params: Optional[Dict[str, torch.Tensor]] = None,
                       epoch: int = 0, global_step: int = 0) -> None:
    """Write a reference-schema ``.pt`` from a GaussianDiffusion module
    (torch_compat.py:258-305). ``ema_params`` (parameter name -> tensor, as
    the trainer keeps them) adds ``ema_state_dict``: the module's state with
    the EMA weights in place of the live ones."""

    def cpu_state(module):
        return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}

    checkpoint: Dict[str, Any] = {
        "epoch": epoch,
        "global_step": global_step,
        "model_state_dict": cpu_state(diffusion),
        "optimizer_state_dict": {},
        "config": {
            "horizon": config["horizon"],
            "observation_dim": config["observation_dim"],
            "action_dim": config["action_dim"],
            "n_timesteps": config["n_timesteps"],
            "beta_schedule": config["beta_schedule"],
            **{k: config[k] for k in _CONFIG_EXTRAS if k in config},
        },
    }
    if ema_params is not None:
        checkpoint["ema_state_dict"] = {
            **checkpoint["model_state_dict"],
            **{k: v.detach().cpu().clone() for k, v in ema_params.items()}}
    torch.save(checkpoint, path)


def load_pt_checkpoint(path: str) -> Dict[str, Any]:
    """Read a ``.pt`` checkpoint onto the CPU (torch_compat.py:308-320).
    It unpickles: load only checkpoints from a trusted source."""
    checkpoint = dict(torch.load(path, map_location="cpu", weights_only=False))
    for key in ("model_state_dict", "ema_state_dict"):
        if checkpoint.get(key):
            checkpoint[key] = {k: torch.as_tensor(np.asarray(v))
                               if not torch.is_tensor(v) else v
                               for k, v in checkpoint[key].items()}
    return checkpoint

