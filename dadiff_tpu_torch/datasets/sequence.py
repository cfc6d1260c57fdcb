"""Horizon-window sequence dataset and a device-prefetching dataloader.

Counterpart of the JAX package's datasets/sequence.py: SequenceDataset :27
(the packed normalized arena, window indexing, ``get_batch`` :174,
``set_normalizer`` :154), DataLoader :183, create_dataloader :221 and
prefetch_to_device :240. Batches are ``{'conditions': (B, H, obs+act)}`` of
normalized interleaved trajectories, obs first. Shuffling is numpy's from a
seed, so this loader and the JAX package's draw the same batches.
Return-to-go targets (``include_returns``) are not ported yet.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional

import numpy as np

from dadiff_tpu_torch.datasets.normalization import DatasetNormalizer
from dadiff_tpu_torch.datasets.sources import Episode, load_episodes


class SequenceDataset:
    """Fixed-length windows over episodes packed into one normalized arena
    (sequence.py:27-180)."""

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

        segments, window_starts, offset = [], [], 0
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
            window_starts.extend(range(offset, offset + T - horizon + 1))
            offset += T
        if not segments:
            raise ValueError(
                f"No usable windows: horizon={horizon} exceeds every episode "
                f"length and use_padding={use_padding}")
        arena = np.concatenate(segments, axis=0)
        self._starts = np.asarray(window_starts, dtype=np.int64)
        self.normalizer = DatasetNormalizer(
            arena[:, : self.observation_dim], arena[:, self.observation_dim:],
            self.observation_dim, self.action_dim, normalizer=normalizer)
        self._arena = self.normalizer.normalize_trajectory(arena)

    def set_normalizer(self, normalizer) -> None:
        """Swap in other stats (e.g. a checkpoint's), renormalizing the arena."""
        phys = self.normalizer.unnormalize_trajectory(self._arena)
        self.normalizer = normalizer
        self._arena = normalizer.normalize_trajectory(phys)

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self._starts[idx]
        return {"conditions": self._arena[s:s + self.horizon]}

    def get_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized window gather: (B, H, transition_dim) in one take."""
        rows = self._starts[idxs][:, None] + np.arange(self.horizon)[None, :]
        return {"conditions": self._arena[rows]}


class DataLoader:
    """Minimal epoch iterator over a SequenceDataset (sequence.py:183-218).
    ``num_workers`` is accepted for parity and ignored: a batch is one
    vectorized gather, and transfer overlap comes from
    :func:`prefetch_to_device`."""

    def __init__(self, dataset: SequenceDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_workers: int = 0):
        del num_workers
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield self.dataset.get_batch(order[i:i + self.batch_size])


def create_dataloader(dataset: SequenceDataset, batch_size: int,
                      shuffle: bool = True, num_workers: int = 0,
                      drop_last: bool = True, seed: int = 0) -> DataLoader:
    """Factory matching the train CLI's call (sequence.py:221-237)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=seed, num_workers=num_workers)


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the iterator's numpy batches as tensors on ``device``, ``size``
    batches ahead (sequence.py:240-261). On a CUDA device each batch is
    staged in a pinned host buffer and copied with ``non_blocking`` on a
    side stream; an event recorded after the copy is waited on by the
    consumer's stream before the batch is handed out, and the pinned buffer
    is kept until then. On the CPU it is a plain conversion."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        staged = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(side):
            on_device = {k: v.to(device, non_blocking=True)
                         for k, v in staged.items()}
            done = torch.cuda.Event()
            done.record(side)
        return on_device, done, staged

    def take():
        on_device, done, _staged = queue.popleft()
        torch.cuda.current_stream(device).wait_event(done)
        for v in on_device.values():   # the consumer's stream now owns them
            v.record_stream(torch.cuda.current_stream(device))
        return on_device

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield take()
    while queue:
        yield take()
