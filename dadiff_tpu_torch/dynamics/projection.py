"""Projection matrix P = F F+ onto dynamics-consistent trajectories (numpy,
float64 on the host).

Counterpart of the JAX package's dynamics/projection.py:24 ProjectionMatrixBuilder.
For x_{t+1} = A x_t + B u_t the consistent concatenated trajectories
[x0..xT, u0..u_{T-1}] are the column space of F = [[A_bar, C_T], [0, I]],
with A_bar the stacked powers of A and C_T the block-Toeplitz forced
response.
"""

from __future__ import annotations

import numpy as np


class ProjectionMatrixBuilder:
    """Trajectory basis F and projector P = F F+ (projection.py:24-95)."""

    def __init__(self, A, B, state_dim: int, action_dim: int,
                 verbose: bool = False):
        A = np.asarray(A, dtype=np.float64)
        B = np.asarray(B, dtype=np.float64)
        if A.shape != (state_dim, state_dim) or B.shape != (state_dim, action_dim):
            raise ValueError(f"A {A.shape} / B {B.shape} do not match "
                             f"n={state_dim}, m={action_dim}")
        self.A, self.B = A, B
        self.state_dim, self.action_dim = state_dim, action_dim
        self.verbose = verbose
        if verbose:
            print(f"ProjectionMatrixBuilder: n={state_dim} m={action_dim} "
                  f"cond(A)={np.linalg.cond(A):.2e}")

    def build_F_matrix(self, horizon: int) -> np.ndarray:
        """F of shape ((T+1)n + Tm, n + Tm) (projection.py:45-72)."""
        T, n, m = horizon, self.state_dim, self.action_dim
        A_bar = np.zeros(((T + 1) * n, n))
        A_power = np.eye(n)
        for t in range(T + 1):
            A_bar[t * n:(t + 1) * n] = A_power
            if t < T:
                A_power = A_power @ self.A
        A_powers_B = [self.B]
        for _ in range(T - 1):
            A_powers_B.append(self.A @ A_powers_B[-1])
        C_T = np.zeros(((T + 1) * n, T * m))
        for t in range(1, T + 1):
            for tau in range(t):
                C_T[t * n:(t + 1) * n, tau * m:(tau + 1) * m] = A_powers_B[t - tau - 1]
        F = np.zeros(((T + 1) * n + T * m, n + T * m))
        F[:(T + 1) * n, :n] = A_bar
        F[:(T + 1) * n, n:] = C_T
        F[(T + 1) * n:, n:] = np.eye(T * m)
        return F

    def get_projection_matrix(self, horizon: int) -> np.ndarray:
        """P = F F+, checked idempotent, as float32 (projection.py:74-89)."""
        F = self.build_F_matrix(horizon)
        P = F @ np.linalg.pinv(F)
        error = np.linalg.norm(P @ P - P, "fro")
        if self.verbose:
            print(f"projection: F{F.shape} ||P^2-P||_F={error:.2e}")
        if error > 1e-4:
            raise RuntimeError(
                f"P is not a valid projection matrix (||P^2-P||_F={error:.2e})")
        return P.astype(np.float32)

    @staticmethod
    def verify_projection(P, atol: float = 1e-4) -> bool:
        """P @ P == P within ``atol`` (projection.py:91-95)."""
        P = np.asarray(P, dtype=np.float64)
        return bool(np.allclose(P @ P, P, atol=atol))
