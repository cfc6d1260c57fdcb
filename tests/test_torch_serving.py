"""Micro-batched serving in the port (serving.py, serve.py --concurrency),
mirroring the JAX package's tests/test_serving.py, on the CPU: sessions,
the batched call against solo plans, the batcher's window, max_batch,
padding and errors, the warm-start refusal, the prewarm's shapes and the
concurrent server end to end; and two observations of the JAX package's
serving with ``--megakernel``.

What the batched call holds (serving.py): (a) a batch of one is the solo
plan bit for bit; (b) a request at the same K_pad with other companions
gives the same plan bit for bit; (c) at another K_pad each plan equals its
solo plan within TOL_LANE: on the CPU the plain ops run in f32, and
PyTorch's CPU conv may group a product's sums differently for another
batch size (observed here: exact on the planner-chain path, up to ~6e-6 on
the module path, after 10 U-Net evaluations).

Tiny model: dim 8, mults (1, 2), horizon 8, T = 10. Every join, wait,
barrier and socket has a timeout and every thread is a daemon: a hang
fails a test instead of stalling the run.
"""

import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from dadiff_tpu_torch.datasets.sequence import SequenceDataset
from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
from dadiff_tpu_torch.guides import policies as pol
from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs_np
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops.planner import _WaveRunner, wire_policy_megakernel
from dadiff_tpu_torch.serve import serve
from dadiff_tpu_torch.serving import BatchedPlanner, _PlanRequest

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS, N = 8, 6, 2, 10, 2
D = OBS + ACT
TOL_LANE = 1e-4
WAIT_S = 120


@pytest.fixture(scope="module")
def parts():
    torch.manual_seed(0)
    dataset = SequenceDataset("synthetic:pointmaze:n=6,T=40", horizon=H)
    diff = GaussianDiffusion(TemporalUnet(D, dim=8, dim_mults=(1, 2)),
                             horizon=H, observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    dt = 0.1
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    B = np.array([[0.5 * dt * dt, 0], [0, 0.5 * dt * dt], [dt, 0], [0, dt]])
    P = ProjectionMatrixBuilder(A, B, 4, ACT).get_projection_matrix(H)
    return diff, dataset, P


def _policy(parts, path, **kw):
    """``module``: an MPC policy on the module-path sampler; ``k2``: a
    dynamics-aware policy wired to the planner chain."""
    diff, dataset, P = parts
    if path == "module":
        return pol.MPCPolicy(diff, dataset.normalizer, action_horizon=4,
                             n_candidates=N, **kw)
    policy = pol.DynamicsAwarePolicy(diff, projection_matrix=P,
                                     normalizer=dataset.normalizer,
                                     action_horizon=4, n_candidates=N, **kw)
    return wire_policy_megakernel(policy, n_candidates=N)


@pytest.fixture(scope="module", params=["module", "k2"])
def batcher(request, parts):
    b = BatchedPlanner(_policy(parts, request.param), max_batch=4,
                       window_ms=200.0)
    yield b
    b.close()


def _obs(i):
    return np.random.RandomState(100 + i).uniform(-1, 1, OBS).astype(
        np.float32)


def _request(policy, seed, i):
    """A request as a session's replan submits it: the conditioning of
    observation ``i`` (tiled to the policy's candidates) and its own
    generator."""
    normed = policy.normalizer.normalize_observations(_obs(i)[None])
    cond = conditions_for_initial_obs_np(
        np.repeat(normed, policy.n_candidates, axis=0), OBS, H, D)
    return _PlanRequest(torch.Generator().manual_seed(seed), cond.values), cond


def _solo(policy, seed, i):
    """The template policy's own replan function on the same draws."""
    _, cond = _request(policy, seed, i)
    return policy._plan(torch.Generator().manual_seed(seed), cond,
                        policy._P, policy._stats)


def _concurrently(fns):
    """Run the thunks in daemon threads released together; their results,
    or the exceptions they raised."""
    out = [None] * len(fns)
    barrier = threading.Barrier(len(fns), timeout=WAIT_S)

    def run(i):
        barrier.wait()
        try:
            out[i] = fns[i]()
        except Exception as e:
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    return out


def test_sessions_independent_and_deterministic(batcher):
    obs = _obs(0)
    p1 = batcher.session(seed=1).plan(obs)
    p2 = batcher.session(seed=2).plan(obs)
    assert p1.shape == (1, H, D) and np.isfinite(p1).all()
    assert not np.allclose(p1, p2)
    np.testing.assert_array_equal(batcher.session(seed=1).plan(obs), p1)


def test_batched_call_against_solo(batcher):
    """(a) a batch of one is the solo plan, bit for bit; (b) at the same
    K_pad other companions leave a plan's bits alone; (c) at K_pad 4 each
    lane is its solo plan within TOL_LANE (module docstring)."""
    policy = batcher.policy
    req = lambda seed, i: _request(policy, seed, i)[0]  # noqa: E731
    solo = [_solo(policy, 10 + i, i) for i in range(4)]
    one = batcher._call([req(10, 0)])[0]
    assert torch.equal(one, solo[0])                                   # (a)
    pair_a = batcher._call([req(10, 0), req(11, 1)])
    pair_b = batcher._call([req(10, 0), req(20, 3)])
    assert torch.equal(pair_a[0], pair_b[0])                           # (b)
    four = batcher._call([req(10 + i, i) for i in range(4)])
    for lane, want in zip(four, solo):                                 # (c)
        assert (lane - want).abs().max().item() <= TOL_LANE
    assert not torch.equal(four[0], four[1])


def test_concurrent_sessions_fold_into_one_call(batcher):
    """4 sessions replan at once: fewer calls than requests, each plan its
    solo plan within TOL_LANE, and the selection of the best candidate
    stays per session."""
    solo = [batcher.session(seed=30 + i).plan(_obs(i)) for i in range(4)]
    calls = batcher.n_calls
    sessions = [batcher.session(seed=30 + i) for i in range(4)]
    out = _concurrently([lambda s=s, i=i: s.plan(_obs(i))
                         for i, s in enumerate(sessions)])
    assert all(isinstance(o, np.ndarray) for o in out), out
    assert batcher.n_calls - calls < 4 and max(batcher.batch_sizes) > 1
    for got, want in zip(out, solo):
        np.testing.assert_allclose(got, want, atol=TOL_LANE)


@pytest.mark.parametrize("kind", ["k2", "ddpm", "consistency"])
def test_plan_draws_through_its_draw(parts, kind):
    """A plan given no noise takes from its generator exactly what its
    sampler's ``draw`` gives (for the planner chain, of two streams): the
    one definition of a plan's draws, which the batcher's per-request
    draws rely on for (a) and (b)."""
    from dadiff_tpu_torch.models.consistency import make_consistency_sampler
    from dadiff_tpu_torch.guides.sampling import make_sampler

    diff = parts[0]
    policy = _policy(parts, "module")
    cond = _request(policy, 0, 0)[1]
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    if kind == "k2":
        plan = _policy(parts, "k2")._plan.sampler
        values = (torch.as_tensor(np.concatenate(
            [_request(policy, 0, i)[1].values[:1] for i in range(2)])),)
        x0, noise = plan.draw(gen(), 2)
        got = plan(gen(), values)
        want = plan(None, values, x0=x0, step_noise=noise)
    else:
        plan = (make_sampler(diff) if kind == "ddpm"
                else make_consistency_sampler(diff, n_steps=3))
        init, noise = plan.draw(gen(), N)
        got = plan(gen(), cond)
        want = plan(None, cond, init_noise=init, step_noise=noise)
    assert torch.equal(got, want)


def test_window_max_batch_and_padding(parts):
    policy = _policy(parts, "module")
    b = BatchedPlanner(policy, max_batch=2, window_ms=200.0)
    try:
        lanes = []
        call = b._call
        b._call = lambda ls: lanes.append(len(ls)) or call(ls)
        out = _concurrently([lambda i=i: b.session(seed=i).plan(_obs(i))
                             for i in range(4)])
        assert all(isinstance(o, np.ndarray) for o in out), out
        assert max(b.batch_sizes) <= 2 and sum(b.batch_sizes) == 4
        assert b.n_requests == 4 and b.n_calls == len(b.batch_sizes)
        # three requests pad to four lanes, the pad repeating request 0
        reqs = [_request(policy, 40 + i, i)[0] for i in range(3)]
        lanes.clear()
        b._execute(reqs)
        assert lanes == [4] and b.batch_sizes[-1] == 3
        assert all(r.event.is_set() and r.result.shape == (N, H, D)
                   for r in reqs)
    finally:
        b.close()


def test_error_reaches_every_waiter(parts):
    b = BatchedPlanner(_policy(parts, "k2"), max_batch=4, window_ms=200.0)

    def broken(lanes):
        raise RuntimeError("wave failed to launch")

    b._call = broken
    try:
        out = _concurrently([lambda i=i: b.session(seed=i).plan(_obs(i))
                             for i in range(3)])
    finally:
        b.close()
    assert all(isinstance(o, RuntimeError) and "wave failed" in str(o)
               for o in out), out


@pytest.mark.parametrize("kw", [{"warm_start_t": 4},
                                {"warm_start_auto": True}],
                         ids=["warm_start_t", "warm_start_auto"])
def test_batching_rejects_warm_start(parts, kw):
    with pytest.raises(ValueError, match="warm-start"):
        BatchedPlanner(_policy(parts, "module", **kw))


@pytest.mark.parametrize("path", ["module", "k2"])
def test_prewarm_runs_the_live_shapes(parts, path):
    """The prewarm at construction runs every padded call with the shapes
    of a live request ((K_pad, candidates, H, D)), so a live burst meets no
    new shape; on the CPU nothing is captured. With the prewarm's record
    cleared the same burst counts as cold."""
    captures = _WaveRunner.captures
    n_values = 1 if path == "k2" else N
    for prewarm in (True, False):
        b = BatchedPlanner(_policy(parts, path), max_batch=4,
                           window_ms=200.0)
        try:
            assert b._warm_shapes == {(k, n_values, H, D) for k in (1, 2, 4)}
            if not prewarm:
                b._warm_shapes.clear()
            out = _concurrently([lambda i=i: b.session(seed=i).plan(_obs(i))
                                 for i in range(3)])
            assert all(isinstance(o, np.ndarray) for o in out), out
            assert (b.cold_calls == 0) == prewarm, (prewarm, b.cold_calls)
        finally:
            b.close()
    assert _WaveRunner.captures == captures


def _rpc(f, req):
    f.write((json.dumps(req) + "\n").encode())
    f.flush()
    return json.loads(f.readline())


def test_concurrent_server_end_to_end(parts):
    """serve(..., concurrency=4) on port 0: three clients plan at once, the
    server stops after max_requests."""
    policy = _policy(parts, "k2")
    box, ready = {}, threading.Event()
    n_clients = 3

    def run():
        box["n"] = serve(policy, "127.0.0.1", 0,
                         max_requests=2 * n_clients,
                         ready_cb=lambda p: (box.update(port=p),
                                             ready.set()),
                         concurrency=4, window_ms=200.0, max_batch=4)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(WAIT_S)
    plans = [None] * n_clients

    def client(i):
        with socket.create_connection(("127.0.0.1", box["port"]),
                                      timeout=WAIT_S) as c:
            f = c.makefile("rwb")
            assert _rpc(f, {"ping": True})["ok"]
            return _rpc(f, {"obs": _obs(i).tolist(), "plan": True})

    out = _concurrently([lambda i=i: client(i) for i in range(n_clients)])
    th.join(timeout=WAIT_S)
    assert not th.is_alive() and box["n"] == 2 * n_clients
    for i, r in enumerate(out):
        assert isinstance(r, dict) and "error" not in r, r
        plans[i] = np.asarray(r["plan"])
        assert plans[i].shape == (H, D) and len(r["action"]) == ACT
    assert not np.allclose(plans[0], plans[1])


# ---------------------------------------------------------------------------
# The JAX package's serving with --megakernel (observations, on the CPU)
# ---------------------------------------------------------------------------

def _jax_policy(scorer=None):
    from dadiff_tpu.guides.policies import DynamicsAwarePolicy as JaxDAP
    from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
    from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
    from dadiff_tpu.ops.pallas_planner import wire_policy_megakernel as jwire

    class _Norm:
        obs_mean = np.zeros(OBS, np.float32)
        obs_std = np.ones(OBS, np.float32)
        action_mean = np.zeros(ACT, np.float32)
        action_std = np.ones(ACT, np.float32)

        def normalize_observations(self, x):
            return np.asarray(x, np.float32)

        def unnormalize_actions(self, x):
            return np.asarray(x, np.float32)

    jdiff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)),
                         horizon=H, observation_dim=OBS, action_dim=ACT,
                         n_timesteps=4)
    params = jax.jit(jdiff.init_params)(jax.random.PRNGKey(0))
    A = np.eye(4) + 0.1 * np.eye(4, k=2)
    B = np.zeros((4, ACT))
    B[2:] = 0.1 * np.eye(ACT)
    P = ProjectionMatrixBuilder(A, B, 4, ACT).get_projection_matrix(H)
    policy = JaxDAP(jdiff, projection_matrix=P.astype(np.float32),
                    normalizer=_Norm(), params=params, state_dim=4,
                    action_horizon=4, n_candidates=4,
                    candidate_scorer=scorer)
    return jwire(policy, n_candidates=4, group_chains=4, interpret=True)


def test_jax_megakernel_selects_without_the_policy_scorer():
    """The JAX package wires --megakernel by setting n_candidates to 1
    (pallas_planner.py:491-493): the wave picks the best candidate by goal
    distance and the policy's candidate_scorer is never called. The port
    refuses another scorer with --megakernel instead
    (tests/test_torch_policies.py)."""
    calls = []

    def scorer(trajs, normed_obs):
        calls.append(trajs.shape)
        return -trajs[:, -1, 0]

    policy = _jax_policy(scorer)
    traj = policy.plan(np.full(OBS, 0.1, np.float32))
    assert traj.shape == (1, H, D) and np.isfinite(traj).all()
    assert policy.n_candidates == 1 and calls == []


def test_jax_batcher_drops_the_megakernel_wiring():
    """The JAX BatchedPlanner rebuilds the XLA sampler from _sampler_config
    (serving.py:78-86) and its sessions keep the wired n_candidates of 1:
    a K2-wired template serves ONE candidate per request through XLA. The
    port batches such a template onto K2 with every candidate
    (test_batched_call_against_solo[k2])."""
    from dadiff_tpu.serving import BatchedPlanner as JaxBatcher

    policy = _jax_policy()
    wired = policy._plan
    b = JaxBatcher(policy, max_batch=2, window_ms=50.0, prewarm=False)
    try:
        shapes = []
        vplan = b._vplan
        b._vplan = lambda keys, values: shapes.append(values.shape) or vplan(
            keys, values)
        sess = b.session(seed=0)
        traj = sess.plan(np.full(OBS, 0.1, np.float32))
    finally:
        b.close()
    assert sess._plan is not wired and sess.n_candidates == 1
    assert shapes == [(1, 1, H, D)] and traj.shape == (1, H, D)
