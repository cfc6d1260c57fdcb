"""Trajectory normalizers (numpy).

A copy of the JAX package's datasets/normalization.py, kept in the port so that it
imports nothing of the JAX package.

The reference is internally inconsistent here: evaluation requests a
``'LimitsNormalizer'`` by name (evaluate.py:168) while the projection and
loss code consume ``obs_mean/obs_std/action_mean/action_std`` attributes
(policies.py:334-337, losses/__init__.py:81-84). We reconcile the two with
one affine abstraction: every normalizer exposes (mean, std) such that
``normalize(x) = (x - mean) / std`` — for the limits normalizer, mean is the
range midpoint and std the half-range, mapping data to [-1, 1] (which is
also what `clip_denoised` in the diffusion model assumes).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np

_EPS = 1e-8


class AffineNormalizer:
    """Base: x_norm = (x - mean) / std, elementwise per feature."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = np.asarray(mean, dtype=np.float32)
        std = np.asarray(std, dtype=np.float32)
        # A constant feature (zero range/variance) would clamp to _EPS and
        # blow any eval-time deviation up to ~1e8 normalized units; scale 1
        # keeps the feature inert instead.
        degenerate = std < 1e-7
        if degenerate.any():
            import warnings

            warnings.warn(
                f"{int(degenerate.sum())} constant feature(s) in normalizer "
                "stats; using scale 1.0 for them", stacklevel=3,
            )
            std = np.where(degenerate, 1.0, std)
        self.std = np.maximum(std, _EPS)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float32) - self.mean) / self.std

    def unnormalize(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) * self.std + self.mean

    def __repr__(self):
        return f"{type(self).__name__}(dim={self.mean.shape})"


class GaussianNormalizer(AffineNormalizer):
    """Mean / standard-deviation normalizer (reference arrays.py:80-107 style)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float32).reshape(-1, data.shape[-1])
        super().__init__(data.mean(axis=0), data.std(axis=0))


class LimitsNormalizer(AffineNormalizer):
    """Min/max normalizer mapping data to [-1, 1] (Janner-style; requested by
    name at reference evaluate.py:168)."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float32).reshape(-1, data.shape[-1])
        lo, hi = data.min(axis=0), data.max(axis=0)
        super().__init__((hi + lo) / 2.0, (hi - lo) / 2.0)


_NORMALIZERS = {
    "GaussianNormalizer": GaussianNormalizer,
    "LimitsNormalizer": LimitsNormalizer,
}


class DatasetNormalizer:
    """Per-field (observations / actions) normalizer bundle.

    Constructor signature matches the reference call site
    ``DatasetNormalizer(dummy_obs, dummy_actions, obs_dim, action_dim)``
    (policies.py:503-508), extended with a strategy name.
    """

    def __init__(
        self,
        observations: np.ndarray,
        actions: np.ndarray,
        observation_dim: int = None,
        action_dim: int = None,
        normalizer: Union[str, type] = "LimitsNormalizer",
    ):
        observations = np.asarray(observations, dtype=np.float32)
        actions = np.asarray(actions, dtype=np.float32)
        self.observation_dim = observation_dim or observations.shape[-1]
        self.action_dim = action_dim or actions.shape[-1]
        cls = _NORMALIZERS[normalizer] if isinstance(normalizer, str) else normalizer
        self.normalizer_name = cls.__name__
        self.obs = cls(observations)
        self.act = cls(actions)

    # -- attributes consumed by projection / loss code (reference
    # policies.py:334-337, losses/__init__.py:81-84) ------------------------
    @property
    def obs_mean(self) -> np.ndarray:
        return self.obs.mean

    @property
    def obs_std(self) -> np.ndarray:
        return self.obs.std

    @property
    def action_mean(self) -> np.ndarray:
        return self.act.mean

    @property
    def action_std(self) -> np.ndarray:
        return self.act.std

    # -- methods consumed by policies (reference policies.py:190,209) -------
    def normalize_observations(self, x):
        return self.obs.normalize(x)

    def unnormalize_observations(self, x):
        return self.obs.unnormalize(x)

    def normalize_actions(self, x):
        return self.act.normalize(x)

    def unnormalize_actions(self, x):
        return self.act.unnormalize(x)

    # -- trajectory helpers (interleaved [obs ‖ act] layout,
    # reference policies.py:184-190) ----------------------------------------
    def normalize_trajectory(self, traj: np.ndarray) -> np.ndarray:
        obs = self.obs.normalize(traj[..., : self.observation_dim])
        act = self.act.normalize(traj[..., self.observation_dim:])
        return np.concatenate([obs, act], axis=-1)

    def unnormalize_trajectory(self, traj: np.ndarray) -> np.ndarray:
        obs = self.obs.unnormalize(traj[..., : self.observation_dim])
        act = self.act.unnormalize(traj[..., self.observation_dim:])
        return np.concatenate([obs, act], axis=-1)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Flat dict of stats (for jit-side use and checkpoint sidecars)."""
        return {
            "obs_mean": self.obs_mean,
            "obs_std": self.obs_std,
            "action_mean": self.action_mean,
            "action_std": self.action_std,
        }

    @classmethod
    def from_arrays(
        cls, stats: Dict[str, np.ndarray], normalizer_name: str = "stored"
    ) -> "DatasetNormalizer":
        """Rebuild from :meth:`as_arrays` output (checkpoint-stored stats, so
        eval normalization matches training exactly regardless of the dataset
        present at eval time)."""
        self = cls.__new__(cls)
        self.obs = AffineNormalizer(stats["obs_mean"], stats["obs_std"])
        self.act = AffineNormalizer(stats["action_mean"], stats["action_std"])
        self.observation_dim = self.obs.mean.shape[-1]
        self.action_dim = self.act.mean.shape[-1]
        self.normalizer_name = normalizer_name
        return self
