"""The on-device evaluator (``envs/rollout.py`` ``make_ondevice_evaluator``)
on the published protocol: ``batch`` envs x ``n_candidates`` chains a
replan, replans of ``action_horizon`` env steps, projection on; K2 waves
for a family whose ``PLANNER`` is ``k2``, the module-path DDPM sampler for
one whose is ``module``.

The window runs whole evaluator calls back to back, each of
``replans_per_call`` replans of an episode, the env state carried into the
next call (``state=``); an episode of ``episode_replans`` replans starts
from the benchmark's own start and goal. No call starts after
``--seconds``; the window ends when the last call ends. Traffic keys:
``batch``, ``replans_per_call``, ``episode_replans``, ``trace_call`` (the
call traced with ``--trace 1``), ``check_envs`` (the envs of one call, drawn
from the seed, that the reference follows).
"""

from __future__ import annotations

import gc
import time

from portbench import inputs, program
from portbench.outcome import Outcome
from portbench.spec import rng, subseed


def run(ctx) -> Outcome:
    import torch

    from portbench import check

    cfg, tr, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    ph = ctx.phases
    B, R = int(tr["batch"]), int(tr["replans_per_call"])
    per_episode = int(tr["episode_replans"]) // R
    program.load_kernels(cfg, dev, ctx.pkg)
    ph.mark("kernel_libraries")
    diff = program.diffusion(
        cfg, inputs.make_weights(cfg, seed, dev, ctx.pkg), dev, ctx.pkg)
    ph.mark("weights")
    data = program.data(cfg, dev)
    ph.mark("normaliser_and_dynamics")
    restore = program.annotate_planner()
    try:
        env = program.maze(cfg)
        evaluate = program.evaluator(cfg, diff, env, data, R, ctx.pkg)
        warm = program.evaluator(cfg, diff, env, data, 1, ctx.pkg)
        ph.mark("evaluator_build")
        episodes = 1 + int(ctx.seconds * 20)   # far more than can run
        starts = inputs.maze_starts(cfg["env"]["maze"], seed, episodes, B)
        pos = torch.as_tensor(starts["pos"], device=dev)
        goal = torch.as_tensor(starts["goal"], device=dev)
        gen = torch.Generator(device=dev).manual_seed(subseed(seed, "plans"))
        warm_gen = torch.Generator(device=dev).manual_seed(
            subseed(seed, "warm"))
        state, _ = env.reset(None, B, dev, pos=pos[0], goal=goal[0])
        warm(warm_gen, data.stats, B, data.P, state=state)
        _sync(dev)
        del warm
        env.log.clear()
        ph.mark("warm_call")
        tracer = None
        if ctx.trace:
            from portbench.trace import Tracer

            tracer = Tracer(ctx.tmpdir)
        calls = []
        t0 = time.perf_counter()
        traced_at = int(tr["trace_call"]) if tracer is not None else -1
        while (not calls or len(calls) <= traced_at
               or time.perf_counter() < t0 + ctx.seconds):
            i = len(calls)
            ep, part = divmod(i, per_episode)
            if part == 0:
                state, _ = env.reset(None, B, dev, pos=pos[ep],
                                     goal=goal[ep])
            call = {"start": state, "snapshot": gen.get_state(),
                    "replans": R, "batch": B}
            traced = i == traced_at
            if traced:
                tracer.start()
            _, state = evaluate(gen, data.stats, B, data.P, state=state)
            _sync(dev)
            if traced:
                tracer.stop()
            call["end"] = time.perf_counter()
            call["log"] = list(env.log)
            env.log.clear()
            calls.append(call)
    finally:
        restore()
    t_end = calls[-1]["end"]
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" \
        else 0
    summary = tracer.read() if tracer is not None else None
    del evaluate, diff, data, env, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    steps_per_call = R * cfg["action_horizon"] * B
    steps = len(calls) * steps_per_call
    r = rng(seed, "check")
    pick = int(r.integers(len(calls)))
    envs = r.choice(B, size=min(B, int(tr["check_envs"])), replace=False)
    t_ref = time.perf_counter()
    checks = check.evaluated(ctx, calls[pick], envs)
    info = {"calls": len(calls), "replans": len(calls) * R,
            "env_steps": steps, "window_s": t_end - t0,
            "checked_call": pick, "reference_s": time.perf_counter() - t_ref}
    records = {"replans_traced": R if summary else 0,
               "chains": B * cfg["n_candidates"]}
    rate = window_rate([c["end"] for c in calls], t0, steps_per_call)
    del calls
    return Outcome(window_start=t0,
                   end_to_end={"eval_env_steps_per_s": rate},
                   attempted=info["replans"],
                   failed=0, memory_peak_bytes=peak, checks=checks,
                   trace=summary, records=records, info=info)


def window_rate(call_ends, t0: float, steps_per_call: int) -> float:
    """Env steps of every call over the window's whole time, from its
    start to the end of its last call: a slow call shows in full."""
    return len(call_ends) * steps_per_call / (call_ends[-1] - t0)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
