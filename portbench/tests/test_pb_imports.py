"""Nothing the benchmark runs imports JAX or the JAX package, compared by
the whole top-level module name (the port's name begins with the JAX
package's); the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import run

PKG = Path(__file__).resolve().parents[1]


def test_whole_names():
    sys_modules = {"dadiff_tpu_torch": 1, "dadiff_tpu_torch.ops": 1,
                   "numpy": 1}
    saved = dict(sys.modules)
    try:
        sys.modules.update(sys_modules)
        found = run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    assert "dadiff_tpu" not in found and "dadiff_tpu_torch" not in found


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(PKG.parent)!r})\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "for cfg, tr in ((tiny.unet(), tiny.traffic('serve_closed8')),\n"
        "                (tiny.transformer(), tiny.traffic('eval_1024'))):\n"
        "    run.execute(cfg, tr, 5, 0.5, torch.device('cpu'))\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_name_no_forbidden_module():
    for path in PKG.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("dadiff_tpu_torch",) + run.FORBIDDEN, \
                (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)
