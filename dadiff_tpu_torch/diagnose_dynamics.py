"""Dynamics-model diagnostics with print verdicts.

Counterpart of the JAX package's scripts/diagnose_dynamics.py: the
analytical double integrator over a dt sweep scored on real transitions,
the data-driven least-squares fit against it, the 10-step open-loop
prediction error, and the projection matrix's health.

    python -m dadiff_tpu_torch.diagnose_dynamics --env PointMaze_UMaze-v3 \\
        --dataset npz:data/pointmaze_umaze_expert.npz

Host numpy only: it runs the same on the card's machine and here.
"""

from __future__ import annotations

import argparse

import numpy as np


def rollout_error(A, B, states, actions, next_states, k: int = 10) -> float:
    """Mean k-step open-loop prediction error of (A, B) on real transitions
    (200 starts drawn with numpy seed 0)."""
    n = len(states) - k
    idx = np.random.RandomState(0).choice(max(n, 1), size=min(200, max(n, 1)),
                                          replace=False)
    errs = []
    for i in idx:
        x = states[i].copy()
        for j in range(k):
            x = A @ x + B @ actions[i + j]
        errs.append(np.linalg.norm(x - next_states[i + k - 1]))
    return float(np.mean(errs))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Dynamics diagnostics")
    p.add_argument("--env", type=str, default="PointMaze_UMaze-v3")
    p.add_argument("--dataset", type=str, default=None,
                   help="episode source for data-driven fits")
    p.add_argument("--horizon", type=int, default=16)
    args = p.parse_args(argv)

    from dadiff_tpu_torch.datasets.sources import load_episodes
    from dadiff_tpu_torch.dynamics.data_driven import (
        extract_transitions_from_episodes,
        fit_linear_dynamics,
    )
    from dadiff_tpu_torch.dynamics.extractor import double_integrator_dynamics
    from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder

    print("=" * 64)
    print(f"Dynamics diagnostics: {args.env}")
    print("=" * 64)
    out = {}
    if args.dataset:
        s, a, ns = extract_transitions_from_episodes(
            load_episodes(args.dataset))
        s4, ns4 = s[:, :4], ns[:, :4]
        print(f"\n[1] analytical double-integrator dt sweep "
              f"({len(s)} real transitions):")
        best = None
        out["dt_sweep"] = {}
        for dt in (0.01, 0.02, 0.05, 0.1):
            A, B = double_integrator_dynamics(dt)
            err = float(np.mean(np.linalg.norm(
                s4 @ A.T + a @ B.T - ns4, axis=1)))
            out["dt_sweep"][dt] = err
            marker = ""
            if best is None or err < best[1]:
                best = (dt, err)
                marker = "  <- best so far"
            print(f"    dt={dt:5.2f}: 1-step err {err:.5f}{marker}")

        print("\n[2] data-driven least-squares fit:")
        A_fit, B_fit = fit_linear_dynamics(s, a, ns, state_dim=4,
                                           verbose=True)
        A_ref, B_ref = double_integrator_dynamics(best[0])
        out.update(best_dt=best[0], r2=fit_linear_dynamics.last_r2,
                   A_fit=A_fit, B_fit=B_fit,
                   dA=float(np.linalg.norm(A_fit - A_ref)),
                   dB=float(np.linalg.norm(B_fit - B_ref)))
        print(f"    ||A_fit - A_dt{best[0]}|| = {out['dA']:.4f}")
        print(f"    ||B_fit - B_dt{best[0]}|| = {out['dB']:.4f}")

        err10 = rollout_error(A_fit, B_fit, s4, a, ns4, k=10)
        verdict = ("EXCELLENT" if err10 < 0.01 else
                   "good" if err10 < 0.1 else "poor")
        out.update(err10=err10, verdict=verdict)
        print(f"\n[3] 10-step open-loop prediction error: {err10:.5f} "
              f"({verdict})")

        print(f"\n[4] projection matrix (horizon={args.horizon}):")
        P = ProjectionMatrixBuilder(A_fit, B_fit, 4, a.shape[1],
                                    verbose=True
                                    ).get_projection_matrix(args.horizon)
        out["idempotent"] = bool(ProjectionMatrixBuilder.verify_projection(P))
        print(f"    P shape {P.shape}, idempotent: {out['idempotent']}")
    else:
        print("no --dataset given; analytical matrices only")
        A, B = double_integrator_dynamics(0.1)
        print(f"A=\n{A}\nB=\n{B}")
    print("\ndone.")
    return out


if __name__ == "__main__":
    main()
