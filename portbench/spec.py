"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, the runner of a mix ``runners/<runner>.py`` and
the reader of a per-layer metric ``metrics/<base>.py``, where ``base`` is
the metric's name up to its first dot. A configuration's ``family`` names
two modules: ``families/<family>.py``, the harness's side (the port's
denoiser, its planner path, its work counts), and
``reference/<family>.py``, the plain forward that decides ``correct``.
``pkg`` is the folder that holds them (this one, or a copy in a test).
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
import numpy as np

PKG = Path(__file__).resolve().parent
REPO = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(repo: Path = REPO) -> dict:
    return load_json(Path(repo) / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str, pkg: Path = PKG) -> dict:
    return load_json(Path(pkg) / "configs" / f"{name}.json")


def load_traffic(name: str, pkg: Path = PKG) -> dict:
    return load_json(Path(pkg) / "traffic" / f"{name}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _part(pkg: Path, folder: str, name: str):
    """``<folder>/<name>.py`` under ``pkg``, loaded once a process: a
    family's modules are asked for at every dispatch. This package's own
    are imported as its submodules, so each file runs once."""
    path = Path(pkg).resolve() / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: {path} is missing")
    if path.parent.parent == PKG.resolve():
        return importlib.import_module(f"portbench.{folder}.{name}")
    return load_module(path, f"portbench_{folder}_{name}")


def runner(name: str, pkg: Path = PKG):
    return load_module(Path(pkg) / "runners" / f"{name}.py",
                       f"portbench_runner_{name}")


def metric_reader(metric: str, pkg: Path = PKG):
    base = metric.split(".")[0]
    return load_module(Path(pkg) / "metrics" / f"{base}.py",
                       f"portbench_metric_{base}")


PLANNERS = ("k2", "module")


def family(cfg, pkg: Path = PKG):
    """``families/<family>.py`` of the configuration: ``PLANNER`` (``k2``,
    the planner chain's waves, or ``module``, the module-path sampler),
    ``denoiser(cfg)``, ``model_flops(cfg, chains)`` and, for K2,
    ``wave_work(cfg, chains)``."""
    name = cfg["family"]
    module = _part(pkg, "families", name)
    if module.PLANNER not in PLANNERS:
        raise SystemExit(f"portbench: families/{name}.py: PLANNER "
                         f"{module.PLANNER!r} is not one of {PLANNERS}")
    return module


def reference(cfg, pkg: Path = PKG):
    """``reference/<family>.py`` of the configuration: ``param_specs(cfg)``
    and ``forward(w, cfg, x, t, prec, cond)``, where ``cond`` (chains,
    observation_dim) is each chain's normalised observation, the one its
    row 0 is conditioned on; a family without a global condition ignores
    it."""
    return _part(pkg, "reference", cfg["family"])


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``bench[kind]`` that the cell reports: those that list
    it under ``workloads``, and those without the key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for one use of the run's seed: the same seed and keys
    give the same number, other keys another."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF]
    for k in keys:
        if isinstance(k, str):
            words.extend(k.encode())
        else:
            words.append(int(k) & 0xFFFFFFFFFFFFFFFF)
    ss = np.random.SeedSequence(words)
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *keys))
