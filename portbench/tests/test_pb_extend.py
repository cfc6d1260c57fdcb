"""A configuration, a traffic mix, a per-layer metric and a denoiser
family are added by new files and new BENCHMARK.json entries alone: a copy
of the benchmark gains a dummy of each, and the harness finds and runs
them by name."""

import hashlib
import json
import shutil

import pytest
import torch

from portbench import run, spec, work
from portbench.outcome import Outcome
from portbench.tests import tiny

# a second name for the U-Net: the port's TemporalUnet, planned by K2
ALIAS_FAMILY = """from portbench.families.unet import (  # noqa: F401
    denoiser, model_flops, wave_work)

PLANNER = "k2"
"""

# the U-Net's reference, keeping each cond it is handed beside the row 0
# (the observation's columns) of the x it came with
ALIAS_REFERENCE = """from portbench.reference import unet
from portbench.reference.unet import param_specs  # noqa: F401

SEEN = []


def forward(w, cfg, x, t, prec=lambda v: v, cond=None):
    SEEN.append((cond, x[:, 0, :cfg["observation_dim"]].clone()))
    return unet.forward(w, cfg, x, t, prec, cond)
"""


def copy_benchmark(tmp_path):
    """A checkout holding a copy of the benchmark; returns (its root, its
    portbench)."""
    repo = tmp_path / "checkout"
    shutil.copytree(spec.PKG, repo / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.REPO / "BENCHMARK.json", repo)
    return repo, repo / "portbench"


def file_hashes(pkg):
    return {str(p.relative_to(pkg)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pkg.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_dummy_config_mix_and_metric(tmp_path):
    repo, pkg = copy_benchmark(tmp_path)
    (pkg / "configs" / "unet_dummy.json").write_text(json.dumps(tiny.unet()))
    (pkg / "traffic" / "serve_dummy.json").write_text(json.dumps(
        dict(spec.load_traffic("serve_closed8"), controllers=2,
             max_batch=2)))
    (pkg / "metrics" / "dummy_requests.py").write_text(
        "def read(name, out, cfg):\n"
        "    return float(len(out.records['latencies_s']))\n")
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unet_dummy", "source": "x",
                             "file": "portbench/configs/unet_dummy.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "unet_dummy.serve_dummy",
                               "config": "unet_dummy",
                               "traffic": "serve_dummy", "chips": 1,
                               "why": "a test's"})
    bench["per_layer"].append({"name": "dummy_requests.serve", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "server", "moves": "plan_p95_ms",
                               "workloads": ["unet_dummy.serve_dummy"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.load_benchmark(repo)
    cell = spec.find(bench["workloads"], "unet_dummy.serve_dummy", "cell")
    cfg = spec.load_config(cell["config"], pkg)
    traffic = spec.load_traffic(cell["traffic"], pkg)
    out, _ = run.execute(cfg, traffic, 11, 0.5, torch.device("cpu"), pkg=pkg)
    assert isinstance(out, Outcome) and out.correct
    names = [m["name"] for m in spec.cell_metrics(
        bench, "unet_dummy.serve_dummy", "per_layer")]
    assert names == ["dummy_requests.serve"]
    reader = spec.metric_reader("dummy_requests.serve", pkg)
    assert reader.read("dummy_requests.serve", out, cfg) == out.attempted
    assert [m["name"] for m in spec.cell_metrics(
        bench, "unet_dummy.serve_dummy", "end_to_end")] == ["setup_s"]


def test_dummy_family(tmp_path):
    repo, pkg = copy_benchmark(tmp_path)
    before = file_hashes(pkg)
    added = {"families/unet_alias.py": ALIAS_FAMILY,
             "reference/unet_alias.py": ALIAS_REFERENCE,
             "configs/unet_alias.json": json.dumps(
                 dict(tiny.unet(), family="unet_alias"))}
    for rel, text in added.items():
        (pkg / rel).write_text(text)
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unet_alias", "source": "x",
                             "file": "portbench/configs/unet_alias.json",
                             "reduced": [], "why": "a test's"})
    cells = ["unet_alias.serve_closed8", "unet_alias.eval_1024"]
    for name in cells:
        bench["workloads"].append({"name": name, "config": "unet_alias",
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "a test's"})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.load_benchmark(repo)
    for name in cells:
        cell = spec.find(bench["workloads"], name, "cell")
        cfg = spec.load_config(cell["config"], pkg)
        seen = spec.reference(cfg, pkg).SEEN
        seen.clear()
        traffic = tiny.traffic(cell["traffic"], trace_from_s=0.2,
                               trace_waves=4)
        out, _ = run.execute(cfg, traffic, 11, 3.0, torch.device("cpu"),
                             trace=True, pkg=pkg)
        assert isinstance(out, Outcome) and out.correct, out.checks
        assert all(v < 1e-3 for v, _ in out.checks.values()), out.checks
        # the reference handed every chain its normalised observation
        assert seen
        for cond, row0 in seen:
            assert cond is not None and torch.equal(cond, row0)
        # the traced readers count the work by the copy's family too
        for m in bench["per_layer"]:
            reader = spec.metric_reader(m["name"], pkg)
            value = reader.read(m["name"], out, cfg)
            assert value == reader.read(m["name"], out,
                                        dict(cfg, family="unet")), m["name"]
        mfu = spec.metric_reader("mfu_pct", pkg).read("mfu_pct", out, cfg)
        assert mfu is not None and mfu > 0
    assert spec.family(cfg, pkg).__file__ == str(
        (pkg / "families" / "unet_alias.py").resolve())
    assert work.wave_work(cfg, 64, pkg) == work.wave_work(
        dict(cfg, family="unet"), 64)
    after = file_hashes(pkg)
    assert {k: v for k, v in after.items() if k not in added} == before
    assert set(after) == set(before) | set(added)


@pytest.mark.parametrize("part,folder", [(spec.family, "families"),
                                         (spec.reference, "reference")])
def test_unknown_family_names_its_file(part, folder):
    with pytest.raises(SystemExit, match=f"{folder}/no_such_family.py"):
        part({"family": "no_such_family"})
