"""The port's projection, sampler, planner chain (K2's host loop on its plain
kernels) and best-of-N sampler, held against the JAX package on the CPU.

Small size as tests/test_pallas_planner.py:34-47 (H=8, dim=32, mults (1,2),
T=6). The JAX planner kernel runs in interpret mode with float32 weights;
tolerances are that file's own (2e-3 plain, 3e-3 with projection).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dadiff_tpu.dynamics.projection import ProjectionMatrixBuilder as JaxPMB
from dadiff_tpu.guides.sampling import ProjectionSpec as JaxSpec
from dadiff_tpu.guides.sampling import conditions_for_initial_obs as jax_cond
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import pallas_planner as jpp
from dadiff_tpu.ops import projection as jproj
from dadiff_tpu.ops.pallas_unet import prepare_chain_operands as jax_prepare

from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec,
    conditions_for_initial_obs,
    make_sampler,
)
from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion, default_timesteps
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import projection as proj
from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
from dadiff_tpu_torch.ops.planner import (
    build_interleaved_projection,
    make_bo_sampler,
    make_planner_chain,
    wire_policy_megakernel,
)

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT = 8, 6, 2
D = OBS + ACT
STATE = 4
T_STEPS = 6
GRID = ((1, 1, 1, 1, 1), (1, 0, 0, 0, 1), (1, 0, 1, 0, 1), (1, 0, 0, 0, 1),
        (1, 1, 1, 1, 1))


@pytest.fixture(scope="module")
def models():
    jax_unet = JaxUnet(transition_dim=D, dim=32, dim_mults=(1, 2))
    jax_diff = JaxDiffusion(model=jax_unet, horizon=H, observation_dim=OBS,
                            action_dim=ACT, n_timesteps=T_STEPS)
    params = jax.jit(jax_diff.init_params)(jax.random.PRNGKey(0))
    unet = TemporalUnet(transition_dim=D, dim=32, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)),
                         strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    return jax_diff, params, diff


@pytest.fixture(scope="module")
def proj_setup():
    A = np.eye(STATE) + 0.1 * np.eye(STATE, k=2)
    B = np.zeros((STATE, ACT))
    B[2:, :] = 0.1 * np.eye(ACT)
    P = ProjectionMatrixBuilder(A, B, STATE, ACT).get_projection_matrix(H)
    np.testing.assert_allclose(P, JaxPMB(A, B, STATE, ACT)
                               .get_projection_matrix(H), atol=1e-6)
    rng = np.random.RandomState(3)
    stats_np = (rng.randn(OBS), 0.5 + rng.rand(OBS), rng.randn(ACT),
                0.5 + rng.rand(ACT))
    jstats = jproj.NormStats(*(jnp.asarray(v, jnp.float32) for v in stats_np))
    stats = proj.NormStats(*(torch.tensor(v, dtype=torch.float32)
                             for v in stats_np))
    return P, jstats, stats


def _inputs(C, seed):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(C, H, D).astype(np.float32)
    noise = rng.randn(T_STEPS, C, H, D).astype(np.float32)
    obs = rng.randn(C, OBS).astype(np.float32)
    return x0, noise, obs


@pytest.mark.parametrize("schedule", ["constant", "linear", "quadratic",
                                      "noise_schedule"])
@pytest.mark.parametrize("walls", [None, 0.0, 0.1])
def test_apply_projection_matches_jax(models, proj_setup, schedule, walls):
    jax_diff, _, diff = models
    P, jstats, stats = proj_setup
    ts = np.arange(T_STEPS)
    a_want = jproj.projection_alpha(jnp.asarray(ts), T_STEPS, schedule, 0.8,
                                    jax_diff.schedule.betas)
    a_got = proj.projection_alpha(torch.from_numpy(ts), T_STEPS, schedule, 0.8,
                                  diff.schedule.betas)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_want), atol=1e-6)
    x = np.random.RandomState(5).randn(3, H, D).astype(np.float32) * 2
    kw = dict(observation_dim=OBS, action_dim=ACT, state_dim=STATE)
    wall = None if walls is None else np.asarray(GRID)
    want = jproj.apply_projection(
        jnp.asarray(x), jnp.asarray(P), a_want[2], jstats,
        wall_grid=None if wall is None else jnp.asarray(wall),
        wall_margin=walls, **kw)
    got = proj.apply_projection(
        torch.from_numpy(x), torch.from_numpy(P), a_got[2], stats,
        wall_grid=None if wall is None else torch.from_numpy(wall),
        wall_margin=walls, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_interleaved_projection_matches_jax(proj_setup):
    P, jstats, stats = proj_setup
    kw = dict(observation_dim=OBS, action_dim=ACT, state_dim=STATE, horizon=H)
    M_want, b_want = jpp.build_interleaved_projection(jnp.asarray(P), jstats, **kw)
    M, b = build_interleaved_projection(P, stats, **kw)
    assert M.dtype == torch.float32 and M.shape == (H * D, H * D)
    np.testing.assert_allclose(M.numpy(), M_want, atol=2e-5)
    np.testing.assert_allclose(b.numpy(), b_want, atol=2e-5)
    x = torch.from_numpy(np.random.RandomState(1).randn(3, H, D)
                         .astype(np.float32))
    for alpha in (1.0, 0.35):
        want = proj.apply_projection(x, torch.from_numpy(P), alpha, stats,
                                     observation_dim=OBS, action_dim=ACT,
                                     state_dim=STATE)
        flat = x.reshape(3, H * D)
        got = alpha * (flat @ M + b) + (1 - alpha) * flat
        np.testing.assert_allclose(got.reshape(3, H, D).numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_default_timesteps_clamp_and_raise():
    assert default_timesteps(6).tolist() == [5, 4, 3, 2, 1, 0]
    assert default_timesteps(6, 3).tolist() == [2, 1, 0]
    for bad in (0, 7):
        with pytest.raises(ValueError):
            default_timesteps(6, bad)


def test_p_sample_loop_matches_jax(models):
    jax_diff, params, diff = models
    x0, noise, _ = _inputs(2, 21)
    want = jax_diff.p_sample_loop(params, jax.random.PRNGKey(0), (2, H, D),
                                  init_noise=jnp.asarray(x0),
                                  step_noise=jnp.asarray(noise))
    got = diff.p_sample_loop((2, H, D), init_noise=torch.from_numpy(x0),
                             step_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


CASES = {
    # name: (n_chains, n_groups, projection, wall margin or None, tolerance)
    "plain": (2, 1, False, None, 2e-3),
    "projection": (2, 1, True, None, 3e-3),
    "wall_aware": (2, 1, True, 0.0, 3e-3),
    "groups": (2, 2, False, None, 2e-3),
}


def _run_port_chain(diff, x0, noise, cond_values, n_chains, n_groups, *,
                    projection=False, M=None, b=None, spec=None, stats=None):
    unet, schedule = diff.model, diff.schedule
    wall = spec.wall_grid if spec is not None else None
    chain = make_planner_chain(
        unet, schedule, H, n_chains, n_groups, projection=projection,
        wall_grid=wall, wall_margin=spec.wall_margin if spec else None,
        pos_stats=None if wall is None else (
            (float(stats.obs_mean[0]), float(stats.obs_mean[1])),
            (float(stats.obs_std[0]), float(stats.obs_std[1]))),
    )
    flat_w, m_embs, scal = prepare_chain_operands(unet, schedule, chain.timesteps,
                                                  torch.float32)
    if projection:
        scal[:, 5] = proj.projection_alpha(chain.timesteps, T_STEPS,
                                           spec.schedule, spec.strength,
                                           schedule.betas)
    C = n_chains * n_groups
    out = chain(flat_w, torch.from_numpy(x0).reshape(C * H, D), m_embs,
                torch.from_numpy(noise).reshape(T_STEPS, C * H, D), scal,
                cond_values.reshape(C * H, D), M, b)
    return out.reshape(C, H, D)


@pytest.mark.parametrize("case", list(CASES))
def test_planner_chain_matches_pallas_kernel(models, proj_setup, case):
    """The port's chain against make_pallas_planner_chain(interpret=True),
    and against the port's own DDPM sampler (the chain's plain version)."""
    n_chains, n_groups, projection, margin, tol = CASES[case]
    jax_diff, params, diff = models
    P, jstats, stats = proj_setup
    C = n_chains * n_groups
    x0, noise, obs = _inputs(C, 7 + len(case))
    wall = GRID if margin is not None else None
    spec = ProjectionSpec(state_dim=STATE, strength=0.8, wall_grid=wall,
                          wall_margin=margin) if projection else None
    M = b = jM = jb = None
    if projection:
        kw = dict(observation_dim=OBS, action_dim=ACT, state_dim=STATE,
                  horizon=H)
        M, b = build_interleaved_projection(P, stats, **kw)
        jM, jb = jpp.build_interleaved_projection(jnp.asarray(P), jstats, **kw)

    jchain = jpp.make_pallas_planner_chain(
        jax_diff.model, jax_diff.schedule, H, n_chains, n_groups,
        projection=projection, wall_grid=None if wall is None else np.asarray(wall),
        wall_margin=margin,
        pos_stats=None if wall is None else (
            (float(jstats.obs_mean[0]), float(jstats.obs_mean[1])),
            (float(jstats.obs_std[0]), float(jstats.obs_std[1]))),
        weight_dtype=jnp.float32, interpret=True)
    fw, me, sc = jax_prepare(jax_diff.model, jax_diff.schedule, params,
                             jchain.timesteps, weight_dtype=jnp.float32)
    if projection:
        sc = sc.at[:, 5].set(jproj.projection_alpha(
            jchain.timesteps, T_STEPS, "noise_schedule", 0.8,
            jax_diff.schedule.betas))
    jcond = jax_cond(jnp.asarray(obs), OBS, H, D)
    want = np.asarray(jchain(
        fw, jnp.asarray(x0).reshape(C * H, D), me,
        jnp.asarray(noise).reshape(T_STEPS, C * H, D), sc,
        jcond.values.reshape(C * H, D),
        None if jM is None else jnp.asarray(jM),
        None if jb is None else jnp.asarray(jb))).reshape(C, H, D)

    cond = conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D)
    got = _run_port_chain(diff, x0, noise, cond.values, n_chains, n_groups,
                          projection=projection, M=M, b=b, spec=spec,
                          stats=stats)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)

    sampler = make_sampler(diff, projection=spec)
    plain = sampler(None, cond, torch.from_numpy(P), stats,
                    init_noise=torch.from_numpy(x0),
                    step_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:, 0, :OBS].numpy(), obs, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0, OBS:].numpy(), 0.0)


def test_planner_chain_chains_are_independent(models):
    """Row-stacking must not leak across chain boundaries
    (test_pallas_planner.py:171-191)."""
    _, _, diff = models
    x0, noise, obs = _inputs(3, 11)
    cond = conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D).values
    stacked = _run_port_chain(diff, x0, noise, cond, 3, 1)
    solo = _run_port_chain(diff, x0[1:2], noise[:, 1:2], cond[1:2], 1, 1)
    np.testing.assert_allclose(stacked[1].numpy(), solo[0].numpy(), atol=1e-5)
    other = _run_port_chain(diff, x0[::-1].copy(), noise[:, ::-1].copy(),
                            cond.flip(0), 3, 1)
    np.testing.assert_allclose(other[1].numpy(), solo[0].numpy(), atol=1e-5)


def test_bo_sampler_matches_pallas_on_injected_noise(models, proj_setup):
    """Best-of-N selection (pallas_planner.py:427-442) on the noise the JAX
    sampler draws, injected into the port's sampler."""
    jax_diff, params, diff = models
    P, jstats, stats = proj_setup
    n_cand, group_chains, B = 3, 4, 2   # C_tot=6 -> 2 groups of 4, 2 padded
    jspec = JaxSpec(state_dim=STATE, schedule="noise_schedule")
    jplan = jpp.make_pallas_bo_sampler(
        jax_diff, projection_spec=jspec, P=jnp.asarray(P), stats=jstats,
        n_candidates=n_cand, group_chains=group_chains,
        weight_dtype=jnp.float32, interpret=True)
    obs = np.random.RandomState(5).randn(B, OBS).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jplan(params, key, jax_cond(jnp.asarray(obs), OBS, H, D)))

    C_pad = 8
    init_key, noise_key = jax.random.split(key)
    x0 = np.array(jax.random.normal(init_key, (C_pad * H, D)))
    noise = np.array(jax.random.normal(noise_key, (T_STEPS, C_pad * H, D)))
    plan = make_bo_sampler(diff, projection_spec=ProjectionSpec(state_dim=STATE),
                           P=P, stats=stats, n_candidates=n_cand,
                           group_chains=group_chains, weight_dtype=torch.float32)
    cond = conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D)
    got = plan(None, cond, x0=torch.from_numpy(x0),
               step_noise=torch.from_numpy(noise))
    assert got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-3, atol=3e-3)


def test_wire_policy_megakernel_cpu(models, proj_setup):
    from dadiff_tpu_torch.guides.policies import DynamicsAwarePolicy

    _, _, diff = models
    P, _, _ = proj_setup

    class _Norm:
        obs_mean = np.zeros(OBS, np.float32)
        obs_std = np.ones(OBS, np.float32)
        action_mean = np.zeros(ACT, np.float32)
        action_std = np.ones(ACT, np.float32)

        def normalize_observations(self, x):
            return np.asarray(x, np.float32)

        def unnormalize_actions(self, x):
            return np.asarray(x, np.float32)

    policy = DynamicsAwarePolicy(diff, projection_matrix=P, normalizer=_Norm(),
                                 state_dim=STATE, action_horizon=4,
                                 n_candidates=4, wall_grid=GRID)
    wire_policy_megakernel(policy, n_candidates=4)
    assert policy.n_candidates == 1 and policy.megakernel
    a = policy.get_action(np.zeros(OBS, np.float32))
    assert a.shape == (ACT,)
    np.testing.assert_array_equal(a, 0.0)  # the executed conditioned t=0 row
    assert len(policy.action_buffer) == 4
    traj = policy.plan(np.full(OBS, 0.1, np.float32))
    assert traj.shape == (1, H, D) and np.isfinite(traj).all()
    np.testing.assert_allclose(traj[0, 0, :OBS], 0.1, atol=1e-6)


# ---------------------------------------------------------------------------
# The conv kernels' tiling, walked on the CPU (ops/conv_tiling.py)
# ---------------------------------------------------------------------------

from dadiff_tpu_torch.ops import chain as ch  # noqa: E402
from dadiff_tpu_torch.ops import conv_tiling as ct  # noqa: E402
from dadiff_tpu_torch.ops import planner as pl  # noqa: E402

KNOWN_TILES = ({(True, *t) for t in ct.MMA_TILES} | {(False, *ct.F32_TILE)})
assert len(KNOWN_TILES) == 5  # DADIFF_WITH_TILE of csrc/common.cuh has five
CONV_MODES = {"same5": (ct.SAME, 5), "same1": (ct.SAME, 1),
              "down": (ct.DOWN, 3), "up": (ct.UP, 4)}
CONV_INPUTS = {
    # name: (cin_a, cin_b, cout, segments, rows per segment)
    "ragged_cin8": (8, 0, 16, 2, 8),      # the first conv: K = 40 at k=5
    "cout8": (32, 0, 8, 2, 8),            # the final 1x1 conv's width
    "concat": (32, 32, 72, 2, 8),         # decoder skip concat, ragged N tile
    "tall": (32, 0, 136, 9, 8),           # 72 rows: the 64-row tiles
}


def _all_splits(rows, cin, w, mode, k):
    """Every split count the launchers can ask for: rows_conv's, the
    one-launch chain's on a one- and a two-block-per-SM grid, and every
    count even_splits can return."""
    bf16 = w.dtype == torch.bfloat16
    M, K, _ = ct.gemm_dims(rows, cin, mode, k)
    k_tiles = -(-K // ct.BK)
    got = {pl._split_k(rows, cin, w.shape[1], mode, k, bf16).splits}
    for grid in (132, 264):
        t = ch._ProgramBuilder("cpu", grid).tiling_for(rows, cin, w, mode, k)
        assert t.splits <= ch.MAX_FAN_IN
        got.add(t.splits)
    got |= {ct.even_splits(k_tiles, want) for want in range(1, k_tiles + 1)}
    return sorted(got)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("inputs", list(CONV_INPUTS))
@pytest.mark.parametrize("conv", list(CONV_MODES))
def test_conv_tiling_rebuilds_rows_conv(conv, inputs, bf16):
    """The kernel's walk (tile, parity, K split, K tile -> tap, input row,
    weight row) gives rows_conv_plain, and multiplies every K index of every
    output tile exactly once, whatever the split."""
    mode, k = CONV_MODES[conv]
    ca, cb, cout, n_seg, seg = CONV_INPUTS[inputs]
    rng = np.random.RandomState(len(conv) + 7 * len(inputs) + bf16)
    rows, cin = n_seg * seg, ca + cb
    taps = 4 if mode == ct.UP else k
    xa = torch.from_numpy(rng.randn(rows, ca).astype(np.float32))
    xb = torch.from_numpy(rng.randn(rows, cb).astype(np.float32)) if cb else None
    w = torch.from_numpy((rng.randn(taps * cin, cout) / cin ** 0.5)
                         .astype(np.float32))
    w = w.to(torch.bfloat16) if bf16 else w
    bias = torch.from_numpy(rng.randn(1, cout).astype(np.float32))
    want = pl.rows_conv_plain(xa, xb, w, bias, mode, k, seg)
    M, K, parities = ct.gemm_dims(rows, cin, mode, k)
    # the tile the launchers take, and every other tile of its weight type
    shapes = [ct.tile_shape(M, bf16, cout, parities)]
    assert (bf16, *shapes[0]) in KNOWN_TILES
    shapes += [t for t in (ct.MMA_TILES if bf16 else ()) if t != shapes[0]]
    work = [(bm, bn, splits) for bm, bn in shapes
            for splits in (_all_splits(rows, cin, w, mode, k)
                           if (bm, bn) == shapes[0]
                           else (ct.even_splits(-(-K // ct.BK), 2),))]
    for bm, bn, splits in work:
        got, cover = ct.rows_conv_tiled(xa, xb, w, bias, mode, k, seg, bm, bn,
                                        splits)
        assert cover.shape == (parities, -(-M // bm), -(-cout // bn), K)
        assert bool((cover == 1).all()), splits
        # f32 sums of at most K = 320 products in another order
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   err_msg=f"splits={splits}")
        ranges = [ct.k_range(s, splits, K) for s in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] and a[0] < a[1] and a[0] % ct.BK == 0
                   for a, b in zip(ranges, ranges[1:] + [(K, K)]))


FLAGSHIP_CONVS = [
    # rows, cin, cout, mode, k at 8 chains x 32 rows, dim 128, mults 1 2 4
    (256, 8, 128, ct.SAME, 5), (256, 128, 128, ct.SAME, 5),
    (256, 128, 128, ct.DOWN, 3), (128, 256, 256, ct.SAME, 5),
    (64, 512, 512, ct.SAME, 5), (64, 1024, 256, ct.SAME, 5),
    (64, 1024, 256, ct.SAME, 1), (64, 256, 256, ct.UP, 4),
    (256, 128, 8, ct.SAME, 1),
]


@pytest.mark.parametrize("shape", FLAGSHIP_CONVS,
                         ids=[f"{r}x{ci}-{co}-m{m}k{k}"
                              for r, ci, co, m, k in FLAGSHIP_CONVS])
def test_split_k_at_the_flagship_shapes(shape):
    rows, cin, cout, mode, k = shape
    for bf16 in (True, False):
        t = pl._split_k(rows, cin, cout, mode, k, bf16)
        assert (bf16, t.bm, t.bn) in KNOWN_TILES
        k_tiles = -(-t.K // ct.BK)
        per_split = -(-k_tiles // t.splits)
        assert (t.splits - 1) * per_split < k_tiles <= t.splits * per_split
        assert t.splits == 1 or (per_split >= 2 and k_tiles >= 8)
        # at most four blocks per SM, unless the tiles alone are more
        assert t.tiles * t.splits <= max(t.tiles, 2 * pl._ROOM + t.tiles)
        assert t.partial_elems == t.parities * t.splits * t.M * cout
        # the batch-1 chain cuts the same conv at one chain's rows
        w = torch.empty(0, cout, dtype=torch.bfloat16 if bf16 else torch.float32)
        c = ch._ProgramBuilder("cpu", 264).tiling_for(rows // 8, cin, w, mode, k)
        assert (bf16, c.bm, c.bn) in KNOWN_TILES
        assert c.splits <= ch.MAX_FAN_IN and c.tiles * c.splits <= max(c.tiles, 264)


# ---------------------------------------------------------------------------
# The fixed-buffer wave runner (the CUDA graph's host side)
# ---------------------------------------------------------------------------

def _plain_launchers(monkeypatch):
    """Stand-ins for the three launchers where there is no card: the plain
    version written into ``out``, counted as a launch."""

    def conv(xa, xb, w, bias, out, mode, k, seg_in, stream=None, scratch=None,
             t=None, counters=None):
        assert t.splits == 1 or counters.numel() >= t.tiles
        out.copy_(pl.rows_conv_plain(xa, xb, w, bias, mode, k, seg_in))
        pl.rows_conv.launches += 1

    def conv_gn(xa, xb, w, bias, out, k, seg_in, scale, gbias, te, te_stride,
                res, gcounters, stream=None, scratch=None, t=None, g=None,
                eps=1e-5):
        assert te is None or te_stride == 0
        out.copy_(pl.rows_conv_gn_plain(xa, xb, w, bias, k, seg_in, scale,
                                        gbias, te, res, eps))
        pl.rows_conv_gn.launches += 1

    def step(x, out, eps, noise, scal_t, cond, M, b, cfg, stream=None):
        assert out.data_ptr() != x.data_ptr()
        out.copy_(pl.ddpm_project_step_plain(x, eps, noise, scal_t, cond, M, b,
                                             cfg))
        pl.ddpm_project_step.launches += 1

    monkeypatch.setattr(pl, "launch_rows_conv", conv)
    monkeypatch.setattr(pl, "launch_rows_conv_gn", conv_gn)
    monkeypatch.setattr(pl, "launch_ddpm_project_step", step)


def _recording_capture(self, wave):
    """Stands in for the CUDA graph: capture runs the wave's host side (its
    launches are counted, as under capture), replay runs it again without
    the wrappers counting, as a graph launch does."""
    wave()

    def replay():
        counts = pl._launch_counts()
        wave()
        pl._set_launch_counts(counts)

    return replay


@pytest.mark.parametrize("projection", [False, True])
def test_wave_runner_staged_buffers_equal_fresh_chains(monkeypatch, models,
                                                       proj_setup, projection):
    """Plans with different observations and noise through the same staged
    buffers equal fresh calls of the chain, the first wave host-driven and
    the later ones replayed; the launch counters add up per wave."""
    _, _, diff = models
    P, _, stats = proj_setup
    _plain_launchers(monkeypatch)
    monkeypatch.setattr(pl._WaveRunner, "_capture", _recording_capture)
    C = 2
    unet, schedule = diff.model, diff.schedule
    cfg = pl.StepConfig(H)
    ts = default_timesteps(T_STEPS)
    M = b = None
    if projection:
        M, b = build_interleaved_projection(
            P, stats, observation_dim=OBS, action_dim=ACT, state_dim=STATE,
            horizon=H)

    def prepared():
        fw, me, sc = prepare_chain_operands(unet, schedule, ts, torch.float32)
        sc[:, 5] = 0.6
        return fw, me, sc

    def inputs(seed):
        x0, noise, obs = _inputs(C, seed)
        cond = conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D)
        return (torch.from_numpy(x0).reshape(C * H, D),
                torch.from_numpy(noise).reshape(T_STEPS, C * H, D),
                cond.values.reshape(C * H, D))

    def fresh(prep, x0, noise, cond):
        fw, me, sc = prep
        return pl.run_chain(pl._PlainOps(), unet, fw, x0, me, noise, sc, cond,
                            M, b, cfg)

    ops = pl._CudaOps("cpu")
    runner = pl._WaveRunner(unet, cfg, ops, (C * H, D), T_STEPS, "cpu")
    prep = prepared()
    n_res = sum(op[0] == "res" for op in pl._program(unet, prep[0]))
    pl._set_launch_counts((0,) * len(pl._launch_counts()))
    per_wave = None
    for wave, seed in enumerate((31, 32, 31)):
        x0, noise, cond = inputs(seed)
        fw, me, sc = prep
        got = runner.run(fw, x0, me, noise, sc, cond, M, b).clone()
        assert torch.equal(got, fresh(prep, x0, noise, cond)), wave
        counts = pl._launch_counts()
        if per_wave is None:
            per_wave = counts
            pool = {k: v.data_ptr() for k, v in ops.pool.items()}
            partner = {k: v.data_ptr() for k, v in ops.partner.items()}
            # time-dense rows once, then T steps of convs, fused convs and
            # one step, which ping-pongs between the iterate and one partner
            assert counts[2] == T_STEPS and (counts[0] - n_res) % T_STEPS == 0
            assert counts[1] % T_STEPS == 0 and counts[1] > 0
            assert len(partner) == 2 and runner.x.data_ptr() in partner
        assert counts == tuple((wave + 1) * n for n in per_wave)
        assert {k: v.data_ptr() for k, v in ops.pool.items()} == pool
        assert {k: v.data_ptr() for k, v in ops.partner.items()} == partner
    assert len(runner.graphs) == 1
    (_, launches, _), = runner.graphs.values()
    assert launches == per_wave
    # graph=False drives the same buffers from the host and counts the same
    x0, noise, cond = inputs(33)
    got = runner.run(*prep[:1], x0, prep[1], noise, prep[2], cond, M, b,
                     graph=False).clone()
    assert torch.equal(got, fresh(prep, x0, noise, cond))
    assert pl._launch_counts() == tuple(4 * n for n in per_wave)
    # other prepared operands: another capture, whose first wave is host-driven
    prep2 = prepared()
    got = runner.run(prep2[0], x0, prep2[1], noise, prep2[2], cond, M, b)
    assert torch.equal(got, fresh(prep2, x0, noise, cond))
    assert len(runner.graphs) == 2
    assert pl._launch_counts() == tuple(5 * n for n in per_wave)
    # only the graphs of the last few operand sets are kept
    first_key = next(iter(runner.graphs))
    for _ in range(runner.MAX_GRAPHS - 1):
        p = prepared()
        runner.run(p[0], x0, p[1], noise, p[2], cond, M, b)
    assert len(runner.graphs) == runner.MAX_GRAPHS
    assert first_key not in runner.graphs


def test_planner_chain_takes_graph_flag_on_cpu(models):
    """On CPU tensors the chain is the plain host loop, with or without the
    flag; the result does not alias a buffer of the chain."""
    _, _, diff = models
    x0, noise, obs = _inputs(2, 41)
    cond = conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D).values
    chain = make_planner_chain(diff.model, diff.schedule, H, 2, 1)
    fw, me, sc = prepare_chain_operands(diff.model, diff.schedule,
                                        chain.timesteps, torch.float32)
    args = (fw, torch.from_numpy(x0).reshape(2 * H, D), me,
            torch.from_numpy(noise).reshape(T_STEPS, 2 * H, D), sc,
            cond.reshape(2 * H, D))
    a, b = chain(*args), chain(*args, graph=False)
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with pytest.raises(ValueError, match="multiple of 8"):
        # the wrapper's check for CUDA tensors, reached here on meta tensors
        pl.rows_conv(torch.zeros(8, 8, device="meta"), None,
                     torch.zeros(8, 12, device="meta"),
                     torch.zeros(1, 12, device="meta"), ct.SAME, 1, 8)


def test_step_launches_of_the_flagship_architecture():
    """What a denoise step launches, recorded from the chain's own host loop
    (the shapes the card is measured at): 35 convs, 25 of them with their
    GroupNorm fused, and 12 residual blocks at three levels, whatever the
    width."""
    from dadiff_tpu_torch.sweep_kernels import step_launches

    unet = TemporalUnet(transition_dim=D, dim=32, dim_mults=(1, 2, 4))
    calls, prog, n_res = step_launches(unet, 8 * 32, D, 32)
    convs = [c for c in calls if c[0] in ("conv", "conv_gn")]
    fused = [c for c in calls if c[0] == "conv_gn"]
    assert (len(convs), len(fused), n_res) == (35, 25, 12)
    assert len(calls) == len(convs)
    assert all(c[5] == ct.SAME and c[6] == 5 for c in fused)
    assert sum(c[8] for c in fused) == n_res         # a time row per block
    assert 100 * (len(calls) + 1) + n_res == 3612   # launches per T=100 wave
    assert {c[1] for c in convs} == {256, 128, 64}  # rows per level, 8 chains
    assert sum(c[5] == ct.DOWN for c in convs) == 2
    assert sum(c[5] == ct.UP for c in convs) == 2
    assert all(c[4] % 8 == 0 for c in convs)        # 16-byte weight chunks
