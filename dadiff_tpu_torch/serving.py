"""Micro-batched concurrent planning: the plan requests of many clients that
arrive within a short window run as one batched call on the card.

Counterpart of the JAX package's serving.py (``BatchedPlanner`` :42-216).
One batcher thread collects the plan requests that arrive within
``window_ms`` (at most ``max_batch``), pads their count to the next power
of two with copies of the first request, and runs them in one call:

  * a template policy wired to the planner chain (``--megakernel``): one K2
    wave of K_pad x n_candidates chains, best of N per request
    (ops/planner.py ``make_bo_sampler`` with K_pad streams);
  * any other policy: the module-path sampler over the requests' stacked
    chains, guidance per chain included (the JAX package vmaps the same
    sampler over its lanes).

Each request's noise comes from its own session's ``torch.Generator``, in
the shapes and order a plan of that session alone draws it, so a plan does
not depend on its batch company. What that makes equal on the card:

  (a) a batch of one is the solo plan, bit for bit (the same wave);
  (b) a request at the same K_pad with other companions gives the same plan,
      bit for bit (chains are independent, every reduction is per chain and
      in a fixed order);
  (c) at another K_pad the wave takes other tiles and splits, so a plan
      equals its solo plan to the chain's bf16 tolerance, not bit for bit
      (the JAX package's vmap keeps one program per lane: bit for bit).

At construction every padded wave (K_pad = 1, 2, 4, ... max_batch) runs
once with the shapes of a live request, which on the card captures its
CUDA graph, so no live burst captures or allocates a new wave.

Spans (utils/profiling.py; the batcher's thread drives the card, so each
wave reads that thread's profiler state): ``batcher.cycle`` (one wave's
whole turn of the batcher's loop) around ``batcher.await`` (the wait for
a wave's first request), ``batcher.window`` (collecting the rest),
``batcher.queue`` (each request, from its submit to its wave's start),
``batcher.wave`` (the call) and, on the client's thread,
``batcher.wait`` (from the submit to the answer). Counters:
:meth:`BatchedPlanner.counters`.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from dadiff_tpu_torch.utils.profiling import (
    current,
    follow_profiler,
    record,
    span,
)

# how long a replan waits for its batch before it gives up
_WAIT_S = 600.0


class _PlanRequest:
    __slots__ = ("generator", "values", "event", "result", "error",
                 "submitted", "parent", "wave")

    def __init__(self, generator, values):
        self.generator = generator
        self.values = values  # (n, H, D) conditioning values
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.submitted = time.perf_counter()
        self.parent = current()  # the submitter's open span, if recording
        self.wave = None


def _padded(k: int) -> int:
    k_pad = 1
    while k_pad < k:
        k_pad *= 2
    return k_pad


class BatchedPlanner:
    """Shared batcher over one template policy (guides/policies.py).

    :meth:`session` gives each client connection a policy clone with its own
    generator, action buffer and plan state, whose replans go through the
    batch queue. ``n_calls``, ``n_requests`` and ``batch_sizes`` count the
    batched calls, ``padded_lanes`` the pad lanes of those calls (K_pad - K
    summed); ``cold_calls`` counts the calls at a shape the prewarm did not
    run."""

    def __init__(self, policy, *, max_batch: int = 8, window_ms: float = 5.0):
        cfg = getattr(policy, "_sampler_config", None)
        if cfg is None:
            raise ValueError("policy does not expose _sampler_config; build "
                             "it from guides/policies.GuidedPolicy")
        if cfg["warm_start_from"] or getattr(policy, "warm_start_auto",
                                             False):
            raise ValueError(
                "micro-batching does not compose with warm-start replanning "
                "(per-client x_init lanes); serve warm-start policies "
                "single-stream")
        self.policy = policy
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.device = policy.device
        self.megakernel = bool(getattr(policy, "megakernel", False))
        if self.megakernel:
            self._wave = policy._plan.sampler
            self._prepared = policy._plan.prepared
        else:
            from dadiff_tpu_torch.guides.sampling import make_sampler

            self._sampler = make_sampler(**dict(cfg, warm_start_from=None))
        self.n_calls = 0
        self.n_requests = 0
        self.batch_sizes: List[int] = []
        self.padded_lanes = 0
        self.cold_calls = 0
        self._wave_id = 0
        self._warm_shapes = set()
        values = np.zeros((policy.n_candidates, policy.horizon,
                           policy.transition_dim), np.float32)
        gen = torch.Generator(device=self.device).manual_seed(0)
        k_pad = 1
        while True:
            self._call([_PlanRequest(gen, values)] * k_pad)
            self._warm_shapes.add((k_pad,) + values.shape)
            if k_pad >= self.max_batch:
                break
            k_pad *= 2
        self._queue: "queue.Queue[_PlanRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client surface -----------------------------------------------------

    def session(self, seed: int = 0):
        """An independent policy clone whose replans go through the batcher
        (serving.py:118-130)."""
        sess = copy.copy(self.policy)
        sess._generator = torch.Generator(device=self.device).manual_seed(seed)
        sess.action_buffer = []
        sess._planned_obs = []
        sess._last_plan = None
        sess._actions_taken = 0
        sess._plan = self._submit_plan
        sess._plan_warm = None
        return sess

    def _submit_plan(self, generator, conditions, P=None, stats=None):
        """A replan function with the sampler's signature that waits for its
        batch; ``P`` and ``stats`` are the template's, as every session's."""
        values = np.asarray(conditions.values, np.float32)
        if values.ndim == 2:
            values = values[None]
        with span("batcher.wait") as sp:
            req = _PlanRequest(generator, values)
            self._queue.put(req)
            answered = req.event.wait(_WAIT_S)
            sp.set(wave=req.wave)
        if not answered:
            raise TimeoutError(f"no batch answered within {_WAIT_S} s")
        if req.error is not None:
            raise req.error
        return req.result

    def counters(self) -> dict:
        """The batcher's cumulative counts (the server's ``stats``)."""
        return {"waves": self.n_calls, "requests": self.n_requests,
                "padded_lanes": self.padded_lanes,
                "cold_calls": self.cold_calls}

    # -- batcher thread -----------------------------------------------------

    def _await(self):
        """The next wave's first request; None once the batcher stops."""
        with span("batcher.await"):
            while not self._stop.is_set():
                try:
                    return self._queue.get(timeout=0.1)
                except queue.Empty:
                    pass
        return None

    def _run(self):
        while True:
            # a wave's whole cycle: between its parts the thread may wait
            # for the interpreter lock while the card idles
            with span("batcher.cycle"):
                first = self._await()
                if first is None:
                    return
                batch = [first]
                with span("batcher.window") as sp:
                    deadline = time.monotonic() + self.window_s
                    while len(batch) < self.max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            batch.append(self._queue.get(timeout=remaining))
                        except queue.Empty:
                            break
                    sp.set(K=len(batch))
                try:
                    self._execute(batch)
                except Exception as e:  # every waiter gets it
                    for req in batch:
                        req.error = e
                        req.event.set()

    def _execute(self, batch: List[_PlanRequest]) -> None:
        K = len(batch)
        k_pad = _padded(K)
        if (k_pad,) + batch[0].values.shape not in self._warm_shapes:
            self.cold_calls += 1
        out = self._call(batch + [batch[0]] * (k_pad - K))
        self.n_calls += 1
        self.n_requests += K
        self.padded_lanes += k_pad - K
        self.batch_sizes.append(K)
        for i, req in enumerate(batch):
            req.result = out[i]
            req.event.set()

    def _call(self, lanes: List[_PlanRequest]) -> List[torch.Tensor]:
        """One batched call over ``lanes`` (a power of two of them, the pad
        lanes repeating a request object); each lane's plans. The wave's
        start ends the ``batcher.queue`` span of each of its requests."""
        follow_profiler()
        self._wave_id += 1
        wave = self._wave_id
        requests = list(dict.fromkeys(lanes))
        chains = len(lanes) * (self._wave.n_candidates if self.megakernel
                               else lanes[0].values.shape[0])
        with span("batcher.wave", wave=wave, K=len(requests),
                  K_pad=len(lanes), chains=chains):
            start = time.perf_counter()
            for r in requests:
                r.wave = wave
                record("batcher.queue", r.submitted, start, parent=r.parent,
                       wave=wave)
            return self._lanes(lanes)

    def _lanes(self, lanes: List[_PlanRequest]) -> List[torch.Tensor]:
        policy = self.policy
        values = torch.as_tensor(np.stack([r.values for r in lanes]),
                                 device=self.device)
        draws = {}  # a pad lane reuses its request's draws
        if self.megakernel:
            with span("wave.draws"):
                for r in lanes:
                    if id(r) not in draws:
                        draws[id(r)] = self._wave.draw(r.generator)
                x0, step_noise = self._wave.stack_draws(
                    [draws[id(r)] for r in lanes], len(lanes))
            out = self._wave(None, (values[:, 0],), self._prepared(),
                             x0=x0, step_noise=step_noise)
            return [out[i:i + 1] for i in range(len(lanes))]
        from dadiff_tpu_torch.guides.sampling import Conditions

        n = values.shape[1]
        with span("wave.draws"):
            for r in lanes:
                if id(r) not in draws:
                    draws[id(r)] = self._sampler.draw(r.generator, n)
        inits, steps = zip(*(draws[id(r)] for r in lanes))
        mask = torch.zeros(policy.horizon, dtype=torch.bool,
                           device=self.device)
        mask[0] = True
        out = self._sampler(
            None, Conditions(values.reshape(-1, *values.shape[2:]), mask),
            policy._P, policy._stats, init_noise=torch.cat(inits),
            step_noise=None if steps[0] is None else torch.cat(steps, dim=1))
        return list(out.reshape(len(lanes), n, *out.shape[1:]))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
