"""Time GroupNorm+Mish where the U-Net's ``use_pallas_norm`` runs it: the
flagship's 25 norms of a train step, and that train step, on a card.

The flagship U-Net (horizon 32, dim 128, mults 1 2 4, T 100) gets weights
from a seed. Two measurements, at each ``--batches`` size:

* The norms. Each ``Conv1dBlock`` is copied with its conv replaced by the
  identity, so that it maps the conv's ``(B, C, H)`` output to what the next
  conv reads, ``(B, C, H)`` contiguous, by the block's own code: with
  ``use_pallas_norm`` (``k1_norm``: K1 and any layout copies around it) and
  without (``library_norm``: ``F.group_norm`` -> ``F.mish``). The forward
  and forward + backward (``torch.autograd.grad`` to the input, the scale
  and the bias) of all 25 are timed replayed from a CUDA graph (``*_ms``,
  the device's time) and driven from the host (``*_host_ms``), beside the
  bound in bytes (forward: x read, y written; backward: x and the incoming
  gradient read, dx written) at 3.35 TB/s.
* The train step (loss, gradient, clip, Adam, EMA) on a batch of the
  dataset, ``k1_norm`` against ``library_norm`` from the same weights,
  batch and draws: ``--repeats`` runs of 10 steps each (CUDA
  events, after two warm-up steps), the two sides in turns, the first side
  alternating. Then the last loss of each and the difference of the two
  weight changes, relative to the library's change.

Prints one JSON object: the card, the package timed, and the numbers.

    python -m dadiff_tpu_torch.bench_gn_mish [--batches 32 256] \\
        [--repeats 6] [--root DIR]

``--root DIR`` times the ``dadiff_tpu_torch`` package of another checkout
(for instance ``git archive`` of an earlier commit unpacked into DIR) with
this file: it runs this file again in a child process started in DIR, so
that the import finds DIR's package first. The file uses only the
interfaces of ``Conv1dBlock``, the losses and the train step, and reads
the K1 launch counts where the package keeps them.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

HORIZON, DIM, MULTS, T_STEPS = 32, 128, (1, 2, 4), 100
DATASET = Path(__file__).resolve().parents[1] / "data" \
    / "pointmaze_umaze_expert.npz"
HBM_BPS = 3.35e12
SEED = 0
STEPS = 10   # train steps a timed run
REPS = 20    # calls a timing of the norms


def _ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph(fn):
    """``fn`` captured once in a CUDA graph, after two warm-up runs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _launches() -> dict:
    from dadiff_tpu_torch.ops import gn_mish as k1

    return {name: getattr(getattr(k1, name, None), "launches", 0)
            for name in ("gn_mish", "gn_mish_backward")}


def _blocks(module):
    from dadiff_tpu_torch.models.temporal_unet import Conv1dBlock

    return [m for m in module.modules() if isinstance(m, Conv1dBlock)]


def _set_norm(module, kernel: bool) -> None:
    for m in _blocks(module):
        m.use_pallas_norm = kernel


def norm_times(unet, batch: int, repeats: int, reps: int, seed: int) -> dict:
    """The 25 norms at ``batch`` through each block's own code, both
    sides, in turns."""
    import torch

    shapes = {}
    hooks = [m.block[1].register_forward_hook(
        lambda mod, inp, out: shapes.__setitem__(mod, tuple(inp[0].shape)))
        for m in _blocks(unet)]
    _set_norm(unet, False)
    with torch.no_grad():
        unet(torch.zeros(batch, HORIZON, unet.transition_dim, device="cuda"),
             torch.zeros(batch, dtype=torch.long, device="cuda"))
    for h in hooks:
        h.remove()
    g = torch.Generator("cuda").manual_seed(seed + batch)
    norms, n_fwd = [], 0
    for m in _blocks(unet):
        B, C, H = shapes[m.block[1]]
        block = copy.deepcopy(m)
        block.block[0] = torch.nn.Identity()
        x = (torch.randn(B, C, H, device="cuda", generator=g) * 2 + 0.3
             ).requires_grad_(True)
        gy = torch.randn(B, C, H, device="cuda", generator=g)
        norms.append((block, x, gy))
        n_fwd += B * C * H

    def forward():
        return [b(x.transpose(1, 2)).transpose(1, 2).contiguous()
                for b, x, _ in norms]

    def backward():
        return [torch.autograd.grad(
            b(x.transpose(1, 2)).transpose(1, 2).contiguous(),
            (x, b.block[1].weight, b.block[1].bias), gy)
            for b, x, gy in norms]

    out = {"norms": len(norms), "fwd_bound_ms": 1e3 * 4 * 2 * n_fwd / HBM_BPS,
           "fwd_bwd_bound_ms": 1e3 * 4 * 5 * n_fwd / HBM_BPS}
    results = {}
    for name in ("k1_norm", "library_norm"):
        for b, _, _ in norms:
            b.use_pallas_norm = name == "k1_norm"
        with torch.no_grad():
            y = forward()
        results[name] = (y, backward())
    err = max([(a - b).abs().max().item() for a, b in zip(
        results["k1_norm"][0], results["library_norm"][0])])
    gerr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for ga, gb in zip(results["k1_norm"][1],
                                 results["library_norm"][1])
               for a, b in zip(ga, gb))
    out.update(fwd_max_abs_diff=err, grad_max_diff=gerr)
    graphs = {}
    for name in ("k1_norm", "library_norm"):
        for b, _, _ in norms:
            b.use_pallas_norm = name == "k1_norm"
        with torch.no_grad():
            graphs[name, "fwd"] = _graph(forward)
        graphs[name, "fwd_bwd"] = _graph(backward)
    order = ["k1_norm", "library_norm"]
    for rep in range(repeats):
        for name in (order if rep % 2 == 0 else order[::-1]):
            for b, _, _ in norms:
                b.use_pallas_norm = name == "k1_norm"
            for part in ("fwd", "fwd_bwd"):
                out.setdefault(f"{name}_{part}_ms", []).append(
                    _ms(graphs[name, part].replay, reps))
            with torch.no_grad():
                out.setdefault(f"{name}_fwd_host_ms", []).append(
                    _ms(forward, reps))
            out.setdefault(f"{name}_fwd_bwd_host_ms", []).append(
                _ms(backward, reps))
    return out


def train_times(batch: int, repeats: int, steps: int, seed: int) -> dict:
    """The train step at ``batch``, ``k1_norm`` and ``library_norm`` from
    the same weights, batch and draws, in turns."""
    import torch

    from dadiff_tpu_torch.datasets.sequence import (
        SequenceDataset, create_dataloader,
    )
    from dadiff_tpu_torch.losses import build_loss, make_generators
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
    from dadiff_tpu_torch.utils import training as tt

    dataset = SequenceDataset(dataset_name=f"npz:{DATASET}", horizon=HORIZON,
                              normalizer="LimitsNormalizer",
                              max_path_length=1000, use_padding=True)
    torch.manual_seed(seed)
    base = GaussianDiffusion(
        TemporalUnet(dataset.observation_dim + dataset.action_dim, dim=DIM,
                     dim_mults=MULTS),
        HORIZON, dataset.observation_dim, dataset.action_dim,
        n_timesteps=T_STEPS).cuda().train()
    start = [p.detach().clone() for p in base.parameters()]
    data = {k: torch.as_tensor(v, device="cuda") for k, v in next(
        iter(create_dataloader(dataset, batch, seed=seed))).items()}
    sides, out = {}, {}
    for name in ("k1_norm", "library_norm"):
        diff = copy.deepcopy(base)
        _set_norm(diff, name == "k1_norm")
        loss_fn, names = build_loss(diff)
        state = tt.TrainState(diff, tt.make_optimizer(diff.parameters()),
                              tt.EMA(diff).shadow)
        step = tt.make_train_step(
            loss_fn, lr_schedule=tt.warmup_cosine_schedule(3e-4, 10, 10000),
            gradient_clip=4.0)
        gens = make_generators(len(names), seed, "cuda")
        before = _launches()
        first = float(step(state, data, gens)["total"])
        after = _launches()
        out[name] = {"first_loss": first, "step_ms": [],
                     "launches_a_step": {k: after[k] - before[k]
                                         for k in after}}
        sides[name] = (lambda s=step, st=state, g=gens: s(st, data, g),
                       diff)
    order = ["k1_norm", "library_norm"]
    for rep in range(repeats):
        for name in (order if rep % 2 == 0 else order[::-1]):
            out[name]["step_ms"].append(_ms(sides[name][0], steps))
    deltas = {}
    for name, (run, diff) in sides.items():
        out[name]["last_loss"] = float(run()["total"])
        deltas[name] = torch.cat([(p.detach() - p0).flatten() for p, p0 in
                                  zip(diff.parameters(), start)])
    lib = deltas["library_norm"]
    out["steps_taken"] = 2 + repeats * (steps + 2)
    out["weight_change_rel_diff"] = float(
        (deltas["k1_norm"] - lib).norm() / lib.norm())
    out["last_loss_rel_diff"] = abs(
        out["k1_norm"]["last_loss"] - out["library_norm"]["last_loss"]) \
        / abs(out["library_norm"]["last_loss"])
    return out


def _rerun_in(root: Path, argv) -> int:
    here = str(Path(__file__).resolve())
    code = (f"import runpy, sys; sys.argv[0] = {here!r}; "
            f"runpy.run_path({here!r}, run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code, *argv],
                          cwd=root).returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[32, 256])
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--root", type=Path, default=None)
    args = p.parse_args(argv)
    if args.root is not None:
        return _rerun_in(args.root.resolve(), [
            "--batches", *map(str, args.batches),
            "--repeats", str(args.repeats)])

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_gn_mish times the card; none is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    import dadiff_tpu_torch
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    out = {"card": _card(), "torch": torch.__version__,
           "package": str(Path(dadiff_tpu_torch.__file__).resolve().parent),
           "repeats": args.repeats, "norms": {}, "train_step": {}}
    torch.manual_seed(SEED)
    unet = TemporalUnet(8, dim=DIM, dim_mults=MULTS).cuda()
    for batch in args.batches:
        out["norms"][batch] = norm_times(unet, batch, args.repeats, REPS,
                                         SEED)
        out["train_step"][batch] = train_times(batch, args.repeats, STEPS,
                                               SEED)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
