"""A configuration, a traffic mix and a per-layer metric are added by new
files and new BENCHMARK.json entries alone: a copy of the benchmark gains
a dummy of each, and the harness finds and runs them by name."""

import json
import shutil

import torch

from portbench import run, spec
from portbench.outcome import Outcome
from portbench.tests import tiny


def test_dummy_config_mix_and_metric(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(spec.PKG, repo / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.REPO / "BENCHMARK.json", repo)
    pkg = repo / "portbench"
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
