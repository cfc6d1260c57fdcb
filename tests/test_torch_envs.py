"""The port's batched PointMaze (dadiff_tpu_torch/envs/pointmaze_jax.py) held
against the JAX package's PointMazeJax on the CPU.

Both envs run in float32 from the same injected states with the same random
actions (large enough to drive the agent into walls). After every step the
JAX state is injected into the port again, so each step is compared on its
own. Contact events (a velocity changed by the contact model) must agree
exactly, positions and velocities to 1e-5 (observed: 1-2 ulp, from sums of
the same terms that XLA may fuse), rewards to 1e-6 and done flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.envs import pointmaze_jax as jenv

from dadiff_tpu_torch.envs import pointmaze_jax as penv

# the envs here are small: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

TOL_STATE = 1e-5
CONTACT = 1e-5
N_ENVS, N_STEPS = 32, 80


def _port_state(s):
    return penv.PointMazeState(*(torch.from_numpy(np.array(v)) for v in s))


def _unconstrained_vel(env, vel, a):
    a = np.clip(a, -1.0, 1.0)
    return np.clip(np.float32(env.damping) * vel + a * np.float32(env.vel_gain),
                   -penv.VELOCITY_LIMIT, penv.VELOCITY_LIMIT)


@pytest.mark.parametrize("reward", ["sparse", "dense"])
@pytest.mark.parametrize("collision", ["disc", "axis"])
@pytest.mark.parametrize("map_name", ["umaze", "medium"])
def test_step_matches_jax(map_name, collision, reward):
    kw = dict(map_name=map_name, collision=collision, reward_type=reward,
              max_episode_steps=N_STEPS // 2)
    jax_env, port_env = jenv.PointMazeJax(**kw), penv.PointMazeJax(**kw)
    state, _ = jax_env.reset(jax.random.PRNGKey(3), N_ENVS)
    # some envs start a little away from their goal, so rewards vary
    goal = np.array(state.goal)
    goal[:4] = np.array(state.pos)[:4] + 0.3
    state = state._replace(goal=jnp.asarray(goal))
    step = jax.jit(jax_env.step)
    rng = np.random.RandomState(0)
    contacts = successes = 0
    for i in range(N_STEPS):
        a = (rng.randn(N_ENVS, 2) * 2).astype(np.float32)
        got, obs, r, done = port_env.step(_port_state(state), torch.from_numpy(a))
        free_vel = _unconstrained_vel(jax_env, np.asarray(state.vel), a)
        state, jobs, jr, jdone = step(state, jnp.asarray(a))
        np.testing.assert_allclose(got.pos.numpy(), np.asarray(state.pos),
                                   atol=TOL_STATE, rtol=0)
        np.testing.assert_allclose(got.vel.numpy(), np.asarray(state.vel),
                                   atol=TOL_STATE, rtol=0)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   atol=TOL_STATE, rtol=0)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(state.t))
        # contact: the contact model changed the integrated velocity (by
        # more than the rounding of the integration itself)
        jax_hit = np.any(np.abs(np.asarray(state.vel) - free_vel) > CONTACT,
                         axis=-1)
        port_hit = np.any(np.abs(got.vel.numpy() - free_vel) > CONTACT,
                          axis=-1)
        np.testing.assert_array_equal(port_hit, jax_hit)
        contacts += int(jax_hit.sum())
        successes += int((np.asarray(jr) > (0.5 if reward == "sparse"
                                            else np.exp(-0.45))).sum())
    assert contacts > N_STEPS // 4, "the walls were hardly touched"
    assert successes > 0
    assert bool(np.asarray(state.done).all())  # t reached max_episode_steps


def test_episode_ends_at_the_goal_when_not_continuing():
    kw = dict(continuing_task=False)
    jax_env, port_env = jenv.PointMazeJax(**kw), penv.PointMazeJax(**kw)
    pos = np.array([[0.0, 1.0], [-1.0, 1.0]], np.float32)
    goal = np.array([[0.3, 1.0], [1.0, -1.0]], np.float32)
    ps, _ = port_env.reset(None, pos=torch.from_numpy(pos),
                           goal=torch.from_numpy(goal))
    js = jenv.PointMazeState(jnp.asarray(pos), jnp.zeros((2, 2)),
                             jnp.asarray(goal), jnp.zeros(2, jnp.int32),
                             jnp.zeros(2, bool))
    a = np.ones((2, 2), np.float32)
    _, _, r, done = port_env.step(ps, torch.from_numpy(a))
    _, _, jr, jdone = jax_env.step(js, jnp.asarray(a))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(done.numpy(), [True, False])
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


@pytest.mark.parametrize("map_name", ["umaze", "medium", "large", "open"])
def test_xy_to_cell_matches_jax(map_name):
    """Negative coordinates floor (not truncate), cell edges fall into the
    next cell, and points outside the maze clip to the border."""
    H, W = np.asarray(jenv.MAZE_MAPS[map_name]).shape
    edges = np.arange(-W / 2 - 1, W / 2 + 1.5, 0.5, dtype=np.float32)
    xs = np.concatenate([edges, edges - 1e-3, edges + 1e-3,
                         np.array([-0.2, -0.7, -1e-6, 0.0], np.float32)])
    xy = np.stack(np.meshgrid(xs, xs[::-1]), -1).reshape(-1, 2)
    row, col = penv.xy_to_cell(torch.from_numpy(xy), H, W)
    jrow, jcol = jenv.xy_to_cell(jnp.asarray(xy), H, W)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    # floor, not truncation: x = -0.2 lies left of the maze's center line
    r, c = penv.xy_to_cell(torch.tensor([[-0.2, -0.2]]), H, W)
    assert int(c) == int(np.floor(-0.2 + W / 2)) and int(r) == int(
        np.floor(H / 2 + 0.2))


@pytest.mark.parametrize("map_name", ["umaze", "medium"])
def test_reset_draws_start_and_goal_in_distinct_free_cells(map_name):
    env = penv.PointMazeJax(map_name=map_name)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(g, 512)
    maze = env.maze
    H, W = maze.shape
    rows, cols = penv.xy_to_cell(state.pos, H, W)
    grows, gcols = penv.xy_to_cell(state.goal, H, W)
    assert (maze[rows.numpy(), cols.numpy()] == 0).all()
    assert (maze[grows.numpy(), gcols.numpy()] == 0).all()
    assert ((rows != grows) | (cols != gcols)).all()
    centers = torch.as_tensor(env._cell_centers())
    d = (state.pos[:, None] - centers[None]).abs().amax(-1).amin(-1)
    assert float(d.max()) <= env.reset_noise + 1e-6
    assert state.pos.dtype == torch.float32 and state.t.dtype == torch.int32
    assert torch.equal(obs, torch.cat([state.pos, state.vel, state.goal], -1))
    # the same generator state gives the same draws
    again, _ = env.reset(torch.Generator().manual_seed(0), 512)
    assert torch.equal(again.pos, state.pos) and torch.equal(again.goal,
                                                             state.goal)
