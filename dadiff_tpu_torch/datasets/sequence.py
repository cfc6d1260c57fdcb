"""Horizon-window dataset: the part that model loading needs.

Counterpart of the JAX package's datasets/sequence.py:27 SequenceDataset, reduced to
the dims, the packed normalized arena, the fitted normalizer and
``set_normalizer`` (:154). Window indexing, the dataloader, return-to-go
targets and device prefetch are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from dadiff_tpu_torch.datasets.normalization import DatasetNormalizer
from dadiff_tpu_torch.datasets.sources import Episode, load_episodes


class SequenceDataset:
    """Episodes packed into one normalized arena (sequence.py:27-152)."""

    def __init__(self, dataset_name: Optional[str] = None, horizon: int = 64,
                 normalizer: str = "LimitsNormalizer",
                 max_path_length: int = 1000, use_padding: bool = True,
                 episodes: Optional[List[Episode]] = None):
        if episodes is None:
            if dataset_name is None:
                raise ValueError("Provide dataset_name or episodes")
            episodes = load_episodes(dataset_name)
        if not episodes:
            raise ValueError("Empty episode list")
        self.dataset_name = dataset_name
        self.horizon = horizon
        self.observation_dim = int(episodes[0]["observations"].shape[-1])
        self.action_dim = int(episodes[0]["actions"].shape[-1])
        self.transition_dim = self.observation_dim + self.action_dim

        segments = []
        for ep in episodes:
            obs = np.asarray(ep["observations"], dtype=np.float32)
            act = np.asarray(ep["actions"], dtype=np.float32)
            T = min(len(act), max_path_length)
            seg = np.concatenate([obs[:T], act[:T]], axis=-1)
            if T < horizon:
                if not use_padding or T == 0:
                    continue
                seg = np.concatenate(
                    [seg, np.repeat(seg[-1:], horizon - T, axis=0)], axis=0)
                T = horizon
            segments.append(seg)
        if not segments:
            raise ValueError(
                f"No usable windows: horizon={horizon} exceeds every episode "
                f"length and use_padding={use_padding}")
        arena = np.concatenate(segments, axis=0)
        self.normalizer = DatasetNormalizer(
            arena[:, : self.observation_dim], arena[:, self.observation_dim:],
            self.observation_dim, self.action_dim, normalizer=normalizer)
        self._arena = self.normalizer.normalize_trajectory(arena)

    def set_normalizer(self, normalizer) -> None:
        """Swap in other stats (e.g. a checkpoint's), renormalizing the arena."""
        phys = self.normalizer.unnormalize_trajectory(self._arena)
        self.normalizer = normalizer
        self._arena = normalizer.normalize_trajectory(phys)
