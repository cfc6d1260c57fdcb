"""Seed-paired A/B comparison of evaluation results.

Counterpart of the JAX package's scripts/compare_results.py: two results
JSON files (or the newest of each of two policy types in a results
directory, as ``evaluate`` names them) side by side: mean reward, length
and success rate, their difference, and the paired episode differences.

    python -m dadiff_tpu_torch.compare_results A.json B.json
    python -m dadiff_tpu_torch.compare_results --results-dir results \\
        --a guided --b dynamics-aware

Host-only (json and numpy); the results of either package compare.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def load_latest(results_dir: str, policy_type: str):
    pattern = os.path.join(results_dir, f"{policy_type}_*.json")
    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no results matching {pattern}")
    with open(files[-1]) as f:
        return json.load(f), files[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compare evaluation results")
    p.add_argument("results", nargs="*", help="two results JSON files")
    p.add_argument("--results-dir", type=str, default="./results")
    p.add_argument("--a", type=str, default="guided", help="policy type A")
    p.add_argument("--b", type=str, default="dynamics-aware",
                   help="policy type B")
    args = p.parse_args(argv)

    if len(args.results) == 2:
        results = []
        for path in args.results:
            with open(path) as f:
                results.append((json.load(f), path))
    else:
        results = [load_latest(args.results_dir, args.a),
                   load_latest(args.results_dir, args.b)]

    (ra, pa), (rb, pb) = results
    print(f"A: {ra['policy_type']} ({pa})")
    print(f"B: {rb['policy_type']} ({pb})")
    if ra.get("seed") != rb.get("seed"):
        print(f"WARNING: seeds differ ({ra.get('seed')} vs {rb.get('seed')}) — "
              "not a paired comparison")

    ma, mb = ra["metrics"], rb["metrics"]
    print(f"\n{'metric':<18}{'A':>12}{'B':>12}{'B-A':>12}")
    for key in ("mean_reward", "mean_length", "success_rate"):
        va, vb = ma.get(key), mb.get(key)
        if va is None or vb is None:
            continue
        print(f"{key:<18}{va:>12.3f}{vb:>12.3f}{vb - va:>12.3f}")

    ra_ep = np.asarray(ma["episode_rewards"], dtype=float)
    rb_ep = np.asarray(mb["episode_rewards"], dtype=float)
    if len(ra_ep) == len(rb_ep):
        diff = rb_ep - ra_ep
        print(f"\npaired episodes: {len(diff)}  mean diff {diff.mean():.3f} "
              f"± {diff.std():.3f}  B wins {int((diff > 0).sum())}/{len(diff)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
