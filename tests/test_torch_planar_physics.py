"""The port's exact planar physics held against the JAX package on the CPU:
the committed models against the JAX extractor, then the mass matrix, the
bias forces, the constraint rows, the constrained forward dynamics with each
solver and one Euler and one RK4 step, on random states that are airborne,
in ground contact and at joint limits.

Both sides run float64 (the JAX side under the x64 fixture of
tests/test_planar_physics.py). The port writes the planar Jacobians out by
hand where JAX differentiates, so the two agree to rounding: 1e-10,
relative where the quantity is large (qacc reaches ~3,000). The JAX engines
come from tests/torch_jax_physics.py, built and jitted once per (env,
solver) and shared with tests/test_torch_locomotion.py.
"""

import numpy as np
import pytest
import torch

import jax

mujoco = pytest.importorskip("mujoco")
gym = pytest.importorskip("gymnasium")

from dadiff_tpu.envs import planar_physics as jp  # noqa: E402

from dadiff_tpu_torch.envs import planar_physics as tp  # noqa: E402
from tests import torch_jax_physics as tj  # noqa: E402

torch.set_num_threads(1)

ENVS = ("HalfCheetah-v5", "Hopper-v5", "Walker2d-v5")
TOL = 1e-10
ITERS = tj.ITERS


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _states(env, seed=0):
    """(qpos, qvel, ctrl), float64: rows 0-1 airborne, 2-3 about the reset
    pose pushed into the ground, 4-5 a limited hinge beyond its range and in
    the ground, 6-7 random poses about the reset height."""
    model = tp.load_planar_model(env)
    rng = np.random.RandomState(seed)
    nv, nu = model.nv, model.nu
    base = model.init_qpos
    qpos = base + rng.uniform(-0.1, 0.1, (8, nv))
    qpos[0:2, 1] += 2.0
    lim = [d for d in range(nv) if model.jnt_limited[d]]
    for r, d in zip((4, 5), (lim[0], lim[-1])):
        lo, hi = model.jnt_range[d]
        qpos[r, d] = (lo - 0.05) if r == 4 else (hi + 0.05)
    qpos[6:8] = base + rng.randn(2, nv) * 0.2
    # the lowest contact sphere 1-3 cm into the ground in rows 2-5
    pts = tp.PlanarPhysics(model).contact_points(torch.from_numpy(qpos))
    gap = (pts[..., 1] - torch.from_numpy(model.con_radius)
           - torch.from_numpy(model.con_margin)).amin(-1).numpy()
    qpos[2:6, 1] -= gap[2:6] + np.array([0.01, 0.03, 0.01, 0.02])
    qvel = rng.randn(8, nv)
    ctrl = rng.uniform(-1.2, 1.2, (8, nu))
    return qpos, qvel, ctrl


def _pair(env, solver="pgs"):
    """The shared JAX engine and the port's, at ITERS iterations."""
    return tj.env(env, solver).phys, tp.PlanarPhysics(
        tp.load_planar_model(env), solver_iters=ITERS, solver=solver)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("search", [False, True], ids=["exact", "search"])
@pytest.mark.parametrize("env", ENVS)
def test_committed_model_equals_the_jax_extractor(env, search):
    """Every field of planar_models/<env>[_search].npz equals the JAX
    extractor's, in value, dtype and shape; the reset constants equal the
    gymnasium env's; the port's own extractor writes the same file."""
    geoms = tp.SEARCH_GEOMS[env] if search else None
    want = jp.extract_planar_model(env, contact_geoms=geoms)
    got = tp.load_planar_model(env, search=search)
    for name in jp.PlanarModel._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert type(a) is type(b) and a == b, name
    host = gym.make(env).unwrapped
    np.testing.assert_array_equal(got.init_qpos, host.init_qpos)
    np.testing.assert_array_equal(got.init_qvel, host.init_qvel)
    assert got.reset_noise_scale == host._reset_noise_scale
    assert got.reset_qvel_normal == (env == "HalfCheetah-v5")
    fresh = tp.extract_planar_model(env, contact_geoms=geoms)
    for name in tp.PlanarModel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(fresh, name)),
                                      np.asarray(getattr(got, name)),
                                      err_msg=name)
    if search:
        assert len(got.con_body) < len(tp.load_planar_model(env).con_body)


def test_loader_refuses_an_unknown_env():
    with pytest.raises(ValueError, match="no planar model"):
        tp.load_planar_model("Ant-v5")
    with pytest.raises(ValueError):
        tp.PlanarPhysics(tp.load_planar_model("Hopper-v5"), solver="newton")


@pytest.mark.parametrize("env", ENVS)
def test_smooth_dynamics_and_constraint_rows_match_jax(env):
    """Mass matrix, bias forces and the constraint rows (J, aref, R,
    active), and the states cover what they claim: contacts active in the
    pushed rows, a limit row active in the limit rows, no contact in the
    airborne rows."""
    _, tph = _pair(env)
    qpos, qvel, _ = _states(env)
    tq, tv = torch.from_numpy(qpos), torch.from_numpy(qvel)
    wM, wbias, wpot, wpts, (wJ, waref, wR, wactive) = tj.rows(
        tj.env(env).smooth_jit, qpos, qvel)
    _close(tph.mass_matrix(tq).numpy(), wM, "mass matrix")
    _close(tph.bias_forces(tq, tv).numpy(), wbias, "bias forces")
    _close(tph._potential(tq).numpy(), wpot, "potential")
    _close(tph.contact_points(tq).numpy(), wpts, "contact points")
    J, aref, R, active = (v.numpy() for v in tph._constraint_rows(tq, tv))
    _close(J, wJ, "J")
    _close(aref, waref, "aref")
    _close(R, wR, "R")
    np.testing.assert_array_equal(active, wactive)
    n_con = tph.pyramid_edges * len(tph.m.con_body)
    assert J.shape[1] == tph.n_rows
    assert not active[0:2, :n_con].any()
    assert active[2:4, :n_con].any(-1).all()
    assert active[4:6, n_con:].any(-1).all()


@pytest.mark.parametrize("solver", ["pgs", "jacobi"])
@pytest.mark.parametrize("env", ENVS)
def test_forward_matches_jax(env, solver):
    """qacc of the constrained forward dynamics at 30 solver iterations."""
    jph, tph = _pair(env, solver)
    qpos, qvel, ctrl = _states(env, seed=1)
    qacc = tph._forward(*(torch.from_numpy(a) for a in (qpos, qvel, ctrl)))
    _close(qacc[0].numpy(),
           tj.rows(jph._forward, qpos, qvel, ctrl)[0], "qacc")


@pytest.mark.parametrize("env,solver", [("HalfCheetah-v5", "pgs"),
                                        ("Hopper-v5", "jacobi")],
                         ids=["euler", "rk4"])
def test_one_step_matches_jax(env, solver):
    """One timestep with the env's integrator: MuJoCo's Euler with implicit
    damping (HalfCheetah) and RK4 (Hopper; Walker2d's RK4 steps are held
    through its env steps in tests/test_torch_locomotion.py)."""
    jph, tph = _pair(env, solver)
    qpos, qvel, ctrl = _states(env, seed=2)
    qp, qv = (v.numpy() for v in tph.step(
        *(torch.from_numpy(a) for a in (qpos, qvel, ctrl))))
    wqp, wqv = tj.rows(jph.step, qpos, qvel, ctrl)
    _close(qp, wqp, "qpos")
    _close(qv, wqv, "qvel")
    assert tph.m.integrator == ("euler" if env == "HalfCheetah-v5" else "rk4")


def test_float32_keeps_its_dtype_and_agrees():
    """A float32 step stays float32 and lies within float32 rounding of the
    float64 step (airborne rows: no contact to flip)."""
    _, tph = _pair("Hopper-v5", "jacobi")
    qpos, qvel, ctrl = (a[:2] for a in _states("Hopper-v5"))
    q64 = tph.step(*(torch.from_numpy(a) for a in (qpos, qvel, ctrl)))
    q32 = tph.step(*(torch.from_numpy(a).float() for a in (qpos, qvel, ctrl)))
    assert all(v.dtype == torch.float32 for v in q32)
    for a, b in zip(q32, q64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), atol=1e-4)
