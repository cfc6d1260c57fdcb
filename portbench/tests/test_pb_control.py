"""On the card: the control (the reference in the precision below the
stated one, put in the port's place) fails the cell's limits, and the port
passes them, on the cells' own configurations and loads with a short
window. The readings the limits were set from: portbench/control.py."""

import pytest

from portbench import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["unet_umaze.serve_closed8",
                                      "unet_umaze.eval_1024",
                                      "transformer_umaze.eval_1024"])
def test_control_fails_and_port_passes(cuda_device, workload):
    run.cache_env(spec.REPO)
    cell = spec.find(spec.load_benchmark()["workloads"], workload, "cell")
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    out, ctx = run.execute(cfg, traffic, 2**31 + 4242, 3.0, cuda_device,
                           control=True)
    assert out.correct, out.checks
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert any(ctx.readings["control"][k] > lim for k, lim in limits.items()
               if k in ctx.readings["control"]), ctx.readings
