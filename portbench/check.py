"""The comparison that decides ``correct``: answers of the window's timed
path against the plain reference (``reference/``: the chain, and the
forward of the configuration's family), recomputed after the window from
the inputs the benchmark made.

A served answer is a plan. The reference recomputes every candidate of the
request (its draws re-drawn from the session's generator, in the order the
session drew them) and ``plan_gap`` is the largest distance, over the
sampled answers, from the served plan to the nearest reference candidate
among those that the goal distance ranks best (within ``tie_margin`` of the
best: a choice between candidates closer than that is rounding's). An
evaluator call is followed replan by replan from the states the port's env
recorded: ``plan_gap`` compares the actions it executed with the
reference's best candidates' in the same way, and ``env_gap`` the states
its env stepped to with the reference's step from the same state and
action.

With ``ctx.control`` the reference in the precision below the stated one
is also put in the port's place (its own best candidate, its own env
step), and both readings go to ``ctx.readings``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import inputs, spec
from portbench.reference import chain, data, maze, precision


class Reference:
    """The reference's operands for one run: derived from the data file and
    the run's seed, never from the port."""

    def __init__(self, ctx):
        cfg, dev = ctx.cfg, ctx.device
        self.cfg, self.device = cfg, dev
        eps = data.load_episodes(inputs.dataset_path(cfg))
        self.stats = data.limits_stats(eps)
        A, B = data.fit_dynamics(eps, cfg["state_dim"])
        self.ops = chain.operands(data.cosine_schedule(cfg["n_timesteps"]),
                                  self.stats,
                                  data.projector(A, B, cfg["horizon"]), dev)
        self.w = inputs.make_weights(cfg, ctx.seed, dev, ctx.pkg)
        self.forward = spec.reference(cfg, ctx.pkg).forward

    def plans(self, obs_norm, x0, noise, product: str) -> torch.Tensor:
        """Every chain's plan with products in ``product`` (a rounding of
        ``precision.ROUNDING``, or ``tf32``)."""
        tf32 = product == "tf32"
        prec = precision.ROUNDING["float32" if tf32 else product]
        cfg = self.cfg

        def eps_fn(x, t, cond):
            return self.forward(self.w, cfg, x, t, prec, cond)

        with precision.float32_products(tf32):
            return chain.plan(eps_fn, self.ops, obs_norm, x0, noise,
                              obs_dim=cfg["observation_dim"],
                              state_dim=cfg["state_dim"])

    def normalize(self, obs: torch.Tensor) -> torch.Tensor:
        return (obs - self.ops.obs_mean) / self.ops.obs_std


def _near_gap(answer, cands, dist, margin: float) -> float:
    """Distance (max abs) from ``answer`` to the nearest of the candidates
    within ``margin`` of the best goal distance."""
    near = dist <= dist.min() + margin
    gaps = (cands[near] - answer[None]).abs().flatten(1).max(dim=1).values
    return float(gaps.min())


def _limits(ctx, runner: str) -> Dict[str, float]:
    return ctx.cfg["limits"][runner]


def served(ctx, items: List[dict]) -> Dict[str, list]:
    """``plan_gap`` over the sampled served answers. ``items``: controller,
    k (its k-th plan, the untimed one 0), obs and the server's reply."""
    from portbench.program import session_seed

    cfg, dev = ctx.cfg, ctx.device
    N, H, D, T = (cfg["n_candidates"], cfg["horizon"], cfg["transition_dim"],
                  cfg["n_timesteps"])
    if not items:
        return {"plan_gap": [float("inf"), _limits(ctx, "serve")["plan_gap"]]}
    ref = Reference(ctx)
    by_session: Dict[int, Dict[int, None]] = {}
    for it in items:
        by_session.setdefault(it["controller"], {})[it["k"]] = None
    drawn = {c: chain.session_draws(session_seed(ctx.seed, c), ks, N * H, D,
                                    T, dev)
             for c, ks in by_session.items()}
    obs = torch.tensor([it["obs"] for it in items], dtype=torch.float32,
                       device=dev)
    obs_norm = ref.normalize(obs).repeat_interleave(N, dim=0)
    x0 = torch.cat([drawn[it["controller"]][it["k"]][0].view(N, H, D)
                    for it in items])
    noise = torch.cat([drawn[it["controller"]][it["k"]][1].view(T, N, H, D)
                       for it in items], dim=1)
    del drawn
    goal = obs[:, cfg["observation_dim"] - 2:cfg["observation_dim"]]
    goal = goal.repeat_interleave(N, dim=0)
    margin = cfg["tie_margin"]

    def gap_of(cands, answers):
        dist = chain.final_distance(cands, goal, ref.ops).view(-1, N)
        c = cands.view(-1, N, H, D)
        return max(_near_gap(answers[i], c[i], dist[i], margin)
                   for i in range(len(items)))

    cands = ref.plans(obs_norm, x0, noise, ctx.product_dtype)
    served_plans = torch.tensor([it["reply"]["plan"] for it in items],
                                dtype=torch.float32, device=dev)
    value = gap_of(cands, served_plans)
    if ctx.control:
        low = ref.plans(obs_norm, x0, noise,
                        precision.BELOW[ctx.product_dtype])
        ld = chain.final_distance(low, goal, ref.ops).view(-1, N)
        best = low.view(-1, N, H, D)[torch.arange(len(items)), ld.argmin(1)]
        ctx.readings.setdefault("program", {})["plan_gap"] = value
        ctx.readings.setdefault("control", {})["plan_gap"] = gap_of(cands,
                                                                    best)
    return {"plan_gap": [value, _limits(ctx, "serve")["plan_gap"]]}


def evaluated(ctx, call: dict, envs: np.ndarray) -> Dict[str, list]:
    """``plan_gap`` and ``env_gap`` over the sampled envs of one evaluator
    call. ``call``: the generator's state before it (``snapshot``), the
    state it started from (``start``) and its env's log."""
    cfg, dev = ctx.cfg, ctx.device
    N, H, D, T = (cfg["n_candidates"], cfg["horizon"], cfg["transition_dim"],
                  cfg["n_timesteps"])
    A, R = cfg["action_horizon"], call["replans"]
    od, ad = cfg["observation_dim"], cfg["action_dim"]
    ref = Reference(ctx)
    log, B = call["log"], call["batch"]
    e = torch.as_tensor(envs, device=dev)
    chains = (e[:, None] * N + torch.arange(N, device=dev)).flatten()
    g = torch.Generator(device=dev)
    g.set_state(call["snapshot"])
    starts = [call["start"]] + [log[r * A - 1][2] for r in range(1, R)]
    obs, x0, noise = [], [], []
    for r, (x0_r, noise_r) in enumerate(chain.draws(g, B * N * H, D, T, R)):
        st = starts[r]
        obs.append(torch.cat([st.pos, st.vel, st.goal], dim=-1)[e])
        x0.append(x0_r.view(B * N, H, D)[chains])
        noise.append(noise_r.view(T, B * N, H, D)[:, chains])
        del x0_r, noise_r
    obs = torch.cat(obs)                              # (R E, od)
    goal = obs[:, od - 2:od].repeat_interleave(N, dim=0)
    obs_norm = ref.normalize(obs).repeat_interleave(N, dim=0)
    x0, noise = torch.cat(x0), torch.cat(noise, dim=1)
    acts = torch.stack([torch.stack([log[r * A + j][1][e]
                                     for j in range(A)], dim=1)
                        for r in range(R)])            # (R, E, A, ad)
    acts = acts.reshape(-1, A, ad)
    margin = cfg["tie_margin"]
    act_mean, act_std = ref.ops.act_mean, ref.ops.act_std

    def actions(plans):
        return plans[:, :A, od:od + ad] * act_std + act_mean

    def plan_gap(cands, answers):
        dist = chain.final_distance(cands, goal, ref.ops).view(-1, N)
        ca = (actions(cands) / act_std).view(-1, N, A, ad)
        an = answers / act_std
        return max(_near_gap(an[i], ca[i], dist[i], margin)
                   for i in range(len(an)))

    def env_gap(dtype=None):
        """The reference's step against the port's recorded one, or (with
        ``dtype``) the step in ``dtype`` against the reference's."""
        worst = 0.0
        for before, action, after in log:
            args = (before.pos[e], before.vel[e], action[e],
                    cfg["env"]["maze"])
            kw = dict(wall_slack=cfg["env"]["wall_slack"])
            pos, vel = maze.step(*args, **kw)
            if dtype is None:
                other = (after.pos[e], after.vel[e])
            else:
                other = maze.step(*args, dtype=dtype, **kw)
            worst = max(worst, float((pos - other[0]).abs().max()),
                        float((vel - other[1]).abs().max()))
        return worst

    cands = ref.plans(obs_norm, x0, noise, ctx.product_dtype)
    out = {"plan_gap": plan_gap(cands, acts),
           "env_gap": env_gap()}
    if ctx.control:
        low = ref.plans(obs_norm, x0, noise,
                        precision.BELOW[ctx.product_dtype])
        ld = chain.final_distance(low, goal, ref.ops).view(-1, N)
        best = low.view(-1, N, H, D)[torch.arange(ld.shape[0]),
                                     ld.argmin(1)]
        ctx.readings.setdefault("program", {}).update(out)
        ctx.readings.setdefault("control", {}).update(
            plan_gap=plan_gap(cands, actions(best)),
            env_gap=env_gap(torch.bfloat16))
    lim = _limits(ctx, "eval")
    return {k: [v, lim[k]] for k, v in out.items()}
