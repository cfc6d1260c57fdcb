"""Declarative experiment configs: ``train --config``.

Counterpart of the JAX package's utils/config.py (load_experiment_config
:48, apply_config_defaults :70). A YAML or JSON file of dataset / model /
diffusion / training / evaluation / system blocks (configs/experiments/*.yaml)
flattens into the train CLI's argument names; flags named on the command
line win over the file, and the file wins over the parser's defaults.
PyYAML is imported only to read a YAML file, so the JSON form needs nothing
beyond the standard library.
"""

from __future__ import annotations

import json
from typing import Any, Dict

# yaml block.key -> CLI arg name (config.py:16-45)
_YAML_TO_ARG = {
    ("dataset", "name"): "dataset",
    ("dataset", "horizon"): "horizon",
    ("dataset", "max_path_length"): "max_path_length",
    ("model", "dim"): "dim",
    ("model", "dim_mults"): "dim_mults",
    ("model", "kernel_size"): "kernel_size",
    ("diffusion", "n_timesteps"): "n_timesteps",
    ("diffusion", "beta_schedule"): "beta_schedule",
    ("diffusion", "loss_type"): "loss_type",
    ("diffusion", "clip_denoised"): "clip_denoised",
    ("diffusion", "predict_epsilon"): "predict_epsilon",
    ("diffusion", "prediction"): "prediction",
    ("training", "n_epochs"): "n_epochs",
    ("training", "batch_size"): "batch_size",
    ("training", "learning_rate"): "lr",
    ("training", "warmup_steps"): "warmup_steps",
    ("training", "gradient_clip"): "gradient_clip",
    ("training", "use_ema"): "use_ema",
    ("training", "ema_decay"): "ema_decay",
    ("training", "save_freq"): "save_freq",
    ("training", "eval_freq"): "eval_freq",
    ("evaluation", "env_name"): "env",
    ("evaluation", "n_episodes"): "n_episodes",
    ("evaluation", "policy_type"): "policy_type",
    ("evaluation", "action_horizon"): "action_horizon",
    ("system", "num_workers"): "num_workers",
    ("system", "seed"): "seed",
    ("system", "device"): "device",
}

# the experiment files were written for the JAX package, whose accelerator
# is "tpu": here the accelerator is the card
_DEVICE = {"tpu": "cuda"}


def load_experiment_config(path: str) -> Dict[str, Any]:
    """A YAML (or ``.json``) experiment file as a flat {arg_name: value}
    (config.py:48-67); unknown top-level scalars pass through."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        raw = json.loads(text)
    else:
        import yaml

        raw = yaml.safe_load(text)
    flat: Dict[str, Any] = {}
    for (block, key), arg in _YAML_TO_ARG.items():
        if isinstance(raw.get(block), dict) and key in raw[block]:
            flat[arg] = raw[block][key]
    for k, v in raw.items():
        if not isinstance(v, dict):
            flat.setdefault(k, v)
    return flat


def explicit_flags(parser, argv) -> set:
    """The dests of the options named in ``argv`` (``--x v`` or ``--x=v``):
    a scan of the command line, since a parsed value equal to its default
    cannot tell ``--dim 128`` from no ``--dim`` (config.py:80-88)."""
    explicit = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if any(a == opt or a.startswith(opt + "=") for a in argv):
                explicit.add(action.dest)
                break
    return explicit


def apply_config_defaults(args, config: Dict[str, Any], parser,
                          argv=None) -> None:
    """Overlay ``config`` on the parsed ``args`` in place: the file wins over
    the parser's defaults, flags named in ``argv`` (``sys.argv[1:]`` when
    None) win over the file; keys the parser lacks are ignored
    (config.py:70-90). A ``device`` of "tpu" becomes "cuda"."""
    import sys

    explicit = explicit_flags(parser, sys.argv[1:] if argv is None else argv)
    for key, value in config.items():
        if hasattr(args, key) and key not in explicit:
            if key == "device":
                value = _DEVICE.get(value, value)
            setattr(args, key, value)
