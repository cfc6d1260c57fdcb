"""The data-collection experts held against the JAX package's on the CPU:
the waypoint controller's actions on a fixed observation stream (exact:
the same numpy arithmetic), its episodes on the host PointMaze, and the
MPPI expert's reward and termination models, actions and episodes on the
host Hopper (exact: the same MuJoCo calls and the same RandomState draws).
The env rollouts skip where gymnasium or mujoco does not import."""

import numpy as np
import pytest

from dadiff_tpu.envs import expert as jexp
from dadiff_tpu.envs import mppi_expert as jmppi
from dadiff_tpu.envs.pointmaze_jax import MAZE_MAPS as JAX_MAPS

from dadiff_tpu_torch.envs import expert, mppi_expert
from dadiff_tpu_torch.envs.pointmaze_jax import MAZE_MAPS


def _assert_episodes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("maze", ["umaze", "medium"])
@pytest.mark.parametrize("opts", [
    {}, {"noise": 0.2, "seed": 3}, {"corner_safe": True},
    {"lookahead": True, "noise": 0.1}])
def test_waypoint_controller_matches_jax(maze, opts):
    """A walk of 60 observations (positions drift toward the goal, which
    changes once): the same actions, the same replans."""
    assert MAZE_MAPS[maze] == JAX_MAPS[maze]
    ours = expert.WaypointController(MAZE_MAPS[maze], **opts)
    theirs = jexp.WaypointController(JAX_MAPS[maze], **opts)
    rng = np.random.RandomState(0)
    H, W = np.asarray(MAZE_MAPS[maze]).shape
    free = np.argwhere(np.asarray(MAZE_MAPS[maze]) == 0)
    cell = free[0]
    pos = np.array([cell[1] + 0.5 - W / 2, H / 2 - cell[0] - 0.5])
    goal = ours._cell_to_xy(tuple(free[-1]))
    for i in range(60):
        if i == 30:
            goal = ours._cell_to_xy(tuple(free[len(free) // 2]))
            ours.reset(), theirs.reset()
        obs = np.concatenate([pos, rng.randn(2) * 0.3, goal])
        a = ours.get_action(obs)
        np.testing.assert_array_equal(a, theirs.get_action(obs))
        pos = pos + 0.1 * a
    assert ours._path and len(ours._path) == len(theirs._path)


def test_expert_episodes_match_jax():
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics")
    kw = dict(env_name="PointMaze_UMaze-v3", n_episodes=2, max_steps=40,
              seed=5, noise=0.2, corner_safe=True)
    _assert_episodes_equal(expert.collect_expert_episodes(**kw),
                           jexp.collect_expert_episodes(**kw))


@pytest.mark.parametrize("env", ["Hopper-v5", "Walker2d-v5",
                                 "HalfCheetah-v5"])
def test_mppi_reward_and_done_models_match_jax(env):
    rng = np.random.RandomState(1)
    ours_r, theirs_r = (mppi_expert._reward_model_for(env),
                        jmppi._reward_model_for(env))
    ours_d, theirs_d = (mppi_expert._done_model_for(env),
                        jmppi._done_model_for(env))
    for _ in range(50):
        # height around the healthy band's edges, small angles and speeds
        obs = np.concatenate([[0.6 + rng.rand()], rng.randn(16) * 0.3])
        a = rng.uniform(-1, 1, 6)
        x0, x1 = rng.randn(2)
        assert ours_r(x0, x1, 0.008, a, obs) == theirs_r(x0, x1, 0.008, a,
                                                          obs)
        assert ours_d(obs) == theirs_d(obs)
    with pytest.raises(ValueError, match="No MPPI reward model"):
        mppi_expert._reward_model_for("Pendulum-v1")


def test_mppi_controller_and_episodes_match_jax():
    """The controller's actions on the host Hopper from one state, then
    ``collect_mppi_episodes`` (one short episode) equal JAX's bit for bit."""
    gym = pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    actions = []
    for mod in (mppi_expert, jmppi):
        env = gym.make("Hopper-v5")
        env.reset(seed=2)
        ctrl = mod.MPPIController(env, horizon=5, n_samples=6, seed=4)
        acts = []
        for _ in range(3):
            a = ctrl.act(env)
            env.step(a.astype(np.float32))
            acts.append(a)
        env.close()
        actions.append(np.stack(acts))
    np.testing.assert_array_equal(actions[0], actions[1])
    kw = dict(env_name="Hopper-v5", n_episodes=1, max_steps=4, horizon=4,
              n_samples=5, seed=1, verbose=False)
    _assert_episodes_equal(mppi_expert.collect_mppi_episodes(**kw),
                           jmppi.collect_mppi_episodes(**kw))
