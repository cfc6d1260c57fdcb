"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, the runner of a mix ``runners/<runner>.py`` and
the reader of a per-layer metric ``metrics/<base>.py``, where ``base`` is
the metric's name up to its first dot. ``pkg`` is the folder that holds
them (this one, or a copy in a test).
"""

from __future__ import annotations

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


def runner(name: str, pkg: Path = PKG):
    return load_module(Path(pkg) / "runners" / f"{name}.py",
                       f"portbench_runner_{name}")


def metric_reader(metric: str, pkg: Path = PKG):
    base = metric.split(".")[0]
    return load_module(Path(pkg) / "metrics" / f"{base}.py",
                       f"portbench_metric_{base}")


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
