"""``train --config``: the port's utils/config.py held against the JAX
package's on every committed experiment file and on a JSON file, the
flags named on the command line winning over the file, and ``train_main``
driven by a JSON config on the CPU. Exact equality throughout (the same
file parsed by the same PyYAML or json)."""

import json
import sys
from pathlib import Path

import pytest
import torch

from dadiff_tpu.cli import build_train_parser as jax_train_parser
from dadiff_tpu.utils import config as jcfg

from dadiff_tpu_torch import cli
from dadiff_tpu_torch.utils import config as cfg
from dadiff_tpu_torch.utils import training as tt

torch.set_num_threads(1)

EXPERIMENTS = sorted(str(p) for p in (Path(__file__).resolve().parents[1]
                                       / "configs" / "experiments"
                                       ).glob("*.yaml"))


def test_every_experiment_file_is_found():
    assert len(EXPERIMENTS) == 4


def _as_json(path, tmp_path):
    yaml = pytest.importorskip("yaml")
    out = tmp_path / "experiment.json"
    out.write_text(json.dumps(yaml.safe_load(open(path))))
    return str(out)


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_experiment_yaml_flattens_as_jax(path):
    pytest.importorskip("yaml")
    assert cfg.load_experiment_config(path) == jcfg.load_experiment_config(path)


def test_experiment_json_flattens_as_jax_without_yaml(tmp_path, monkeypatch):
    """A JSON file needs no PyYAML (the card's machine may lack it)."""
    path = _as_json(EXPERIMENTS[0], tmp_path)
    want = jcfg.load_experiment_config(path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert cfg.load_experiment_config(path) == want
    assert want["dataset"] and want["dim_mults"]


@pytest.mark.parametrize("path", EXPERIMENTS)
@pytest.mark.parametrize("flags", [[], ["--dim", "64"], ["--dim=64", "--lr",
                                                          "1e-3"]])
def test_config_overlay_matches_jax(path, flags):
    """The train namespace after the overlay equals the JAX CLI's on every
    shared argument, but ``device`` ("tpu" in the files: the card here);
    named flags win over the file."""
    pytest.importorskip("yaml")
    argv = ["--config", path] + flags
    jp, tp = jax_train_parser(), cli.build_train_parser()
    ja, ta = jp.parse_args(argv), tp.parse_args(argv)
    jcfg.apply_config_defaults(ja, jcfg.load_experiment_config(path), jp,
                               argv=argv)
    cfg.apply_config_defaults(ta, cfg.load_experiment_config(path), tp,
                              argv=argv)
    shared = set(vars(ja)) & set(vars(ta))
    differ = {k for k in shared if getattr(ja, k) != getattr(ta, k)}
    assert differ <= {"device"}
    assert ja.device == "tpu" and ta.device == "cuda"
    if flags:
        assert ta.dim == 64
    else:
        assert ta.dim == jcfg.load_experiment_config(path)["dim"]


def test_explicit_flags_are_scanned_from_argv():
    p = cli.build_train_parser()
    assert cfg.explicit_flags(p, ["--dim", "8", "--lr=1", "--no-use-ema"]) \
        == {"dim", "lr", "use_ema"}
    assert cfg.explicit_flags(p, ["--dimension", "8"]) == set()


def test_train_main_takes_a_json_config(tmp_path, monkeypatch):
    """Three steps configured by a JSON file; ``--batch-size`` on the
    command line wins over the file's."""
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "dataset": {"name": "synthetic:pointmaze:n=6,T=40", "horizon": 8},
        "model": {"dim": 16, "dim_mults": [1, 2]},
        "diffusion": {"n_timesteps": 6},
        "training": {"batch_size": 8, "warmup_steps": 2, "eval_freq": 0},
        "system": {"device": "cpu", "seed": 3}}))
    seen = {}
    train = tt.Trainer.train

    def spy(self, *a, **kw):
        seen.update(json.load(open(f"{self.log_dir}/config.json")))
        return train(self, *a, **kw)

    monkeypatch.setattr(tt.Trainer, "train", spy)
    log_dir = cli.train_main(["--config", str(path), "--batch-size", "4",
                              "--n-epochs", "1", "--max-steps", "3",
                              "--log-freq", "1", "--log-dir", str(tmp_path)])
    assert (seen["batch_size"], seen["horizon"], seen["dim"], seen["seed"],
            seen["device"]) == (4, 8, 16, 3, "cpu")
    final = json.load(open(f"{log_dir}/final_config.json"))
    assert (final["dim"], final["dim_mults"], final["n_timesteps"]) == \
        (16, [1, 2], 6)
