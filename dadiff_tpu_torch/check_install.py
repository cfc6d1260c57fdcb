"""Installation and environment check with a PASS/FAIL summary.

Counterpart of the JAX package's scripts/check_install.py, for the port:
torch and numpy, the package, the card, ``nvcc``, one build of the CUDA
kernels (dadiff_tpu_torch/csrc, into build/dadiff_tpu_torch/), a module
forward and loss on the card, the hermetic data sources; and, reported
but never failing, the optional host-side packages (gymnasium and
gymnasium_robotics for the host evaluator and the data collectors, mujoco,
minari, PyYAML for YAML experiment configs).

    python -m dadiff_tpu_torch.check_install          # on the card
    python -m dadiff_tpu_torch.check_install --device cpu

``--device cpu`` leaves out the card, nvcc and the build, and runs the
forward on the host. Exits 0 when every required check passes.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Tuple


def _imports():
    import numpy
    import torch

    return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
            f"numpy {numpy.__version__}")


def _package():
    import dadiff_tpu_torch

    return dadiff_tpu_torch.__name__


def _card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible")
    return (f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}, "
            f"capability {torch.cuda.get_device_capability(0)}")


def _nvcc():
    import subprocess

    from dadiff_tpu_torch.ops import cuda_lib

    path = cuda_lib._nvcc()
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return f"{path}: {out.strip().splitlines()[-1]}"


def _build():
    from dadiff_tpu_torch.ops import cuda_lib

    took = cuda_lib.build_all()
    for name in took:
        cuda_lib.lib(name)
    return ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) or \
        "every library already built"


def _forward(device: str):
    import torch

    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    g = torch.Generator(device=device).manual_seed(0)
    d = GaussianDiffusion(TemporalUnet(8, dim=16, dim_mults=(1, 2)), 8, 6, 2,
                          n_timesteps=10).to(device)
    x = torch.randn(2, 8, 8, generator=g, device=device)
    with torch.no_grad():
        loss = d.loss(x, generator=g)
    if not torch.isfinite(loss):
        raise RuntimeError(f"loss {float(loss)}")
    return f"loss {float(loss):.3f} on {device}"


def _synthetic():
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset

    ds = SequenceDataset("synthetic:pointmaze:n=2,T=20", horizon=8)
    return f"{len(ds)} windows"


def _npz():
    from pathlib import Path

    import dadiff_tpu_torch
    from dadiff_tpu_torch.datasets.sources import load_episodes

    path = (Path(dadiff_tpu_torch.__file__).resolve().parents[1] / "data"
            / "pointmaze_umaze_expert.npz")
    return f"{len(load_episodes(f'npz:{path}'))} episodes of {path.name}"


def _optional(module: str, why: str) -> Callable[[], str]:
    def run():
        import importlib

        try:
            m = importlib.import_module(module)
        except ImportError:
            return f"not installed ({why})"
        return f"{module} {getattr(m, '__version__', '')}".strip()
    return run


def checks(device: str) -> List[Tuple[str, Callable[[], str]]]:
    out = [("core imports (torch, numpy)", _imports),
           ("dadiff_tpu_torch package", _package)]
    if device == "cuda":
        out += [("CUDA device", _card), ("nvcc", _nvcc),
                ("kernel build (csrc/*.cu, sm_90a)", _build)]
    out += [
        ("model forward (TemporalUnet + diffusion loss)",
         lambda: _forward(device)),
        ("hermetic dataset (synthetic)", _synthetic),
        ("hermetic dataset (npz)", _npz),
    ]
    return out


OPTIONAL = [
    ("gymnasium (optional)", _optional(
        "gymnasium", "host evaluator and gym/expert/mppi collectors off")),
    ("gymnasium_robotics (optional)", _optional(
        "gymnasium_robotics", "host PointMaze off")),
    ("mujoco (optional)", _optional(
        "mujoco", "numerical dynamics and MPPI expert off")),
    ("minari (optional)", _optional(
        "minari", "hermetic sources available: synthetic/npz/gym/expert/mppi")),
    ("yaml (optional)", _optional(
        "yaml", "train --config takes JSON only")),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Check the port's installation")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    results = []
    for name, fn in checks(args.device) + OPTIONAL:
        try:
            results.append((name, True, fn() or ""))
        except Exception as e:  # every check reports, none stops the others
            results.append((name, False, f"{type(e).__name__}: {e}"))
    print("=" * 64)
    n_pass = 0
    for name, ok, detail in results:
        n_pass += ok
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    print("=" * 64)
    print(f"{n_pass}/{len(results)} checks passed")
    return 0 if n_pass == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
