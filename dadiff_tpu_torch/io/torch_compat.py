"""Reference-schema ``.pt`` checkpoints, and weights carried over from the
JAX package.

Counterpart of the JAX package's io/torch_compat.py: unet_key_mapping :58,
infer_model_config_from_checkpoint :202, save_pt_checkpoint :258 and
load_pt_checkpoint :308. The schema is
``{epoch, global_step, model_state_dict, optimizer_state_dict, config,
ema_state_dict?}`` with the denoiser under ``model.`` and the 12 schedule
buffers at the top of ``model_state_dict``.

``params_from_jax`` turns a Flax TemporalUnet parameter tree (as numpy)
into the port's TemporalUnet state dict, ``transformer_params_from_jax`` a
Flax TemporalTransformer tree into the port's TemporalTransformer's,
``value_params_from_jax`` a Flax
ValueNet tree into the port's ValueNet's; ``block_params_from_jax`` one
residual block's dict and ``train_state_from_jax`` an optax Adam state and
EMA tree. Layouts:
  Conv1d          flax (k, in, out) -> torch (out, in, k)
  ConvTranspose1d jax  (k, out, in) -> torch (in, out, k)
  Dense           flax (in, out)    -> torch Linear (out, in)
  GroupNorm       scale/bias        -> weight/bias
  attention q/k/v flax (in, heads, head_dim) -> torch Linear (out, in)
  attention out   flax (heads, head_dim, out) -> torch Linear (out, in)

A transformer ``.pt`` is the port's own schema: the JAX trainer writes a
``.pt`` for U-Nets only and keeps transformers in orbax
(utils/training.py:420-425), while the port's only format is ``.pt``. It
holds the module's state dict (``model.*`` and the 12 schedule buffers) and
the config keys of ``_CONFIG_EXTRAS``, ``model_type: transformer`` among
them; a checkpoint without ``model_type`` is a U-Net.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _res_keys(prefix: str, name: str):
    """The key table of one ResidualTemporalBlock."""
    return [
        (f"{prefix}.blocks.0.block.0", (name, "block1", "conv"), "conv"),
        (f"{prefix}.blocks.0.block.1", (name, "block1", "norm"), "norm"),
        (f"{prefix}.blocks.1.block.0", (name, "block2", "conv"), "conv"),
        (f"{prefix}.blocks.1.block.1", (name, "block2", "norm"), "norm"),
        (f"{prefix}.time_mlp.1", (name, "time_dense"), "dense"),
        (f"{prefix}.residual_conv", (name, "residual_conv"), "conv"),
    ]


def unet_key_mapping(n_levels: int) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch prefix, flax path, kind) for every TemporalUnet layer
    (torch_compat.py:41-82); torch prefixes are relative to the unet."""
    table = [
        ("time_mlp.1", ("time_dense1",), "dense"),
        ("time_mlp.3", ("time_dense2",), "dense"),
        ("final_conv.0.block.0", ("final_block", "conv"), "conv"),
        ("final_conv.0.block.1", ("final_block", "norm"), "norm"),
        ("final_conv.1", ("final_conv",), "conv"),
    ]
    for i in range(n_levels):
        table += _res_keys(f"downs.{i}.0", f"down_{i}_res1")
        table += _res_keys(f"downs.{i}.1", f"down_{i}_res2")
        if i < n_levels - 1:
            table.append((f"downs.{i}.2.conv", (f"down_{i}_downsample",), "conv"))
    table += _res_keys("mid_block1", "mid_block1")
    table += _res_keys("mid_block2", "mid_block2")
    for i in range(n_levels - 1):
        table += _res_keys(f"ups.{i}.0", f"up_{i}_res1")
        table += _res_keys(f"ups.{i}.1", f"up_{i}_res2")
        table.append((f"ups.{i}.2.conv", (f"up_{i}_upsample",), "convtranspose"))
    return table


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax TemporalUnet params (nested dicts of numpy arrays) -> the port's
    ``TemporalUnet`` state dict, loadable with ``strict=True``."""
    n_levels = sum(1 for k in params if k.startswith("down_") and k.endswith("_res1"))
    return _state_from_table(params, unet_key_mapping(n_levels))


def transformer_params_from_jax(params: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax TemporalTransformer params (nested dicts of numpy arrays) -> the
    port's ``TemporalTransformer`` state dict, loadable with
    ``strict=True``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def dense(prefix, node):
        return {f"{prefix}.weight": t(np.asarray(node["kernel"]).T),
                f"{prefix}.bias": t(node["bias"])}

    state = {"pos_emb": t(params["pos_emb"])}
    for name in ("time_dense1", "time_dense2", "in_proj", "final_mod",
                 "out_proj"):
        state.update(dense(name, params[name]))
    depth = sum(1 for k in params if k.startswith("block_"))
    for i in range(depth):
        blk, pre = params[f"block_{i}"], f"blocks.{i}"
        for name in ("adaln_mod", "mlp1", "mlp2"):
            state.update(dense(f"{pre}.{name}", blk[name]))
        for name in ("query", "key", "value"):
            k = np.asarray(blk["attn"][name]["kernel"])   # (in, heads, hd)
            state[f"{pre}.attn.{name}.weight"] = t(
                k.reshape(k.shape[0], -1).T)
            state[f"{pre}.attn.{name}.bias"] = t(
                np.asarray(blk["attn"][name]["bias"]).reshape(-1))
        k = np.asarray(blk["attn"]["out"]["kernel"])      # (heads, hd, out)
        state[f"{pre}.attn.out.weight"] = t(k.reshape(-1, k.shape[-1]).T)
        state[f"{pre}.attn.out.bias"] = t(blk["attn"]["out"]["bias"])
    return state


def value_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ValueNet params (numpy) -> the port's ``ValueNet`` state dict,
    loadable with ``strict=True`` (models/value_net.py names its modules
    after the Flax tree)."""
    n_levels = sum(1 for k in params if k.startswith("enc_")
                   and k.endswith("_res"))
    table = [("time_mlp.1", ("time_dense1",), "dense"),
             ("time_mlp.3", ("time_dense2",), "dense"),
             ("head1", ("head1",), "dense"), ("head2", ("head2",), "dense")]
    for i in range(n_levels):
        table += _res_keys(f"blocks.{i}", f"enc_{i}_res")
        if i < n_levels - 1:
            table.append((f"downs.{i}", (f"enc_{i}_down",), "conv"))
    return _state_from_table(params, table)


def mlp_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of a DynamicsMLP or InverseDynamicsMLP (``Dense_0`` ..
    ``Dense_L``, numpy) -> the state dict of envs/learned_model.py's MLP of
    the same widths, loadable with ``strict=True``. Each kernel (in, out)
    becomes the weight (out, in). An ensemble-stacked tree (a leading member
    axis on every leaf, as train_dynamics_ensemble returns it) becomes the
    stacked layers' (E, out, in) weights and (E, out) biases."""
    n = sum(1 for k in params if k.startswith("Dense_"))
    state = {}
    for i in range(n):
        node = params[f"Dense_{i}"]
        state[f"layers.{i}.weight"] = torch.tensor(np.swapaxes(
            np.asarray(node["kernel"], np.float32), -1, -2).copy())
        state[f"layers.{i}.bias"] = torch.tensor(
            np.asarray(node["bias"], np.float32))
    return state


def _state_from_table(params, table) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in table:
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
    """Architecture from weight shapes (torch_compat.py:202-255), and the
    model family from the config's ``model_type`` (a U-Net without it). A
    transformer's dim, depth and mlp_ratio come from its weights, its
    n_heads from the config (JAX's default of 4 without it)."""
    state = checkpoint["model_state_dict"]
    saved = checkpoint.get("config", {}) or {}
    n_timesteps = (int(state["betas"].shape[0]) if "betas" in state
                   else int(saved.get("n_timesteps", 200)))
    common = {
        "n_timesteps": n_timesteps,
        "beta_schedule": saved.get("beta_schedule", "cosine"),
        "horizon": saved.get("horizon", 16),
        "observation_dim": saved.get("observation_dim"),
        "action_dim": saved.get("action_dim"),
    }
    if saved.get("model_type", "unet") == "transformer":
        dim = int(state["model.in_proj.weight"].shape[0])
        return {
            "model_type": "transformer", "dim": dim, "dim_mults": [],
            "depth": sum(1 for k in state if k.startswith("model.blocks.")
                         and k.endswith(".adaln_mod.weight")),
            "n_heads": int(saved.get("n_heads", 4)),
            "mlp_ratio": int(state["model.blocks.0.mlp1.weight"].shape[0])
            // dim,
            "transition_dim": int(state["model.out_proj.weight"].shape[0]),
            **common,
        }
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
        "model_type": "unet",
        "dim": dim,
        "dim_mults": list(dim_mults),
        "transition_dim": int(state[fkey].shape[0]) if fkey in state else None,
        **common,
    }


_CONFIG_EXTRAS = ("normalizer_name", "normalizer_stats", "predict_epsilon",
                  "clip_denoised", "prediction", "consistency", "sigma_data",
                  "teacher_checkpoint", "model_type", "dim", "depth",
                  "n_heads", "mlp_ratio", "progressive", "progressive_steps")


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

