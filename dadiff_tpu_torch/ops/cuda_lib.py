"""Build and load the port's CUDA kernels (``dadiff_tpu_torch/csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``. Builds
go to ``build/dadiff_tpu_torch/`` at the root of the checkout, keyed by a
hash of the source, of the shared headers (``csrc/*.cuh``) and of the flags,
so an edited source or header is rebuilt and an unchanged one is reused. All
missing libraries are compiled at once, one ``nvcc`` process per source,
started together.

Every C entry point takes device pointers and a stream as ``c_void_p`` and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dadiff_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library -> {C function: argtypes}; every function returns int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gn_mish": {
        # x, out, scale, bias, te, te_stride, res, stats, n_seg, seg, C,
        # groups, eps, channels_first, vec, nv, threads, stream
        "gn_mish": [P, P, P, P, P, I, P, P, I, I, I, I, F, I, I, I, I, P],
        # x, g, scale, bias, stats, dx, part, dscale, dbias, dte, planes,
        # n_seg, seg, C, groups, channels_first, vec, nv, threads, stream
        "gn_mish_backward": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                             I, I, I, P],
    },
    "planner": {
        # xa, xb, cin_a, cin_b, w, w_bf16, bias, out, rows_in, seg_in, cout,
        # mode, k, bm, bn, splits, partial, counters, stream
        "rows_conv": [P, P, I, I, P, I, P, P, I, I, I, I, I, I, I, I, P, P, P],
        # xa, xb, cin_a, cin_b, w, w_bf16, bias, out, rows, seg_in, cout, k,
        # bm, bn, splits, partial, scale, gbias, te, te_stride, res, eps,
        # gtm, gtn, ns, ng, gcounters, stream
        "rows_conv_gn": [P, P, I, I, P, I, P, P, I, I, I, I, I, I, I, P,
                         P, P, P, I, P, F, I, I, I, I, P, P],
        # xa, xb, cin_a, cin_b, w, bias, out, rows_in, seg_in, cout, mode,
        # k, bn, stages, splits, partial, counters, stream
        "rows_conv_wg": [P, P, I, I, P, P, P, I, I, I, I, I, I, I, I, P, P,
                         P],
        # xa, xb, cin_a, cin_b, w, bias, out, rows, seg_in, cout, k, bn,
        # stages, scale, gbias, te, te_stride, res, eps, stream
        "rows_conv_gn_wg": [P, P, I, I, P, P, P, I, I, I, I, I, I, P, P, P,
                            I, P, F, P],
        # x, out, eps, noise, scal, cond, M, b, n_chains, H, D, clip,
        # predict_eps, wall, grid_h, grid_w, mx, my, sx, sy, margin, stream
        "ddpm_project_step": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                              P, I, I, F, F, F, F, F, P],
    },
    "chain": {
        # out[4]: blocks per SM, SMs, cooperative launch, sizeof(ChainOp)
        "chain_limits": [P],
        # prog, n_pre, n_step, T, grid, prof, stream
        "chain_run": [P, I, I, I, I, P, P],
        # n, grid, stream
        "grid_sync_probe": [I, I, P],
    },
    "resblock": {
        # out[4]: blocks per SM, SMs, cooperative launch, sizeof(ChainOp)
        "resblock_limits": [P],
        # ops (host), n_ops, x, te, out, grid, prof, stream
        "resblock_run": [P, I, P, P, P, I, P, P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_counters: Dict[str, object] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    # the headers are shared: an edit to one rebuilds every library
    src = b"".join(f.read_bytes() for f in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every library that is not built yet, all in parallel.
    Returns the seconds each build took (0 for a library already built)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp,
                       target, time.perf_counter())
    took = {name: 0.0 for name in SIGNATURES}
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _libs:
            if not _target(name).exists():
                build_all()
            cdll = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def counters(device, n: int, stream: int):
    """A zeroed int32 array of at least ``n`` entries on ``device`` for the
    split-K tile counters of launches on ``stream`` (a pointer, as
    :func:`stream_of` gives it); kernels leave it zeroed. One per (device,
    stream): launches on two streams at once never share one."""
    import torch

    key = (str(device), int(stream or 0))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1 << 14), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device (a CUDA tensor), as a
    pointer, read without building a ``torch.cuda.Stream`` (a few
    microseconds of host time a launch, which host-bound steps pay)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
