"""The port's value function held against the JAX package on the CPU:
``ValueNet``'s forward with weights carried over by ``value_params_from_jax``,
``value_loss`` and its gradient with the JAX loss's own draws of t and the
noise injected, one Adam step, the dataset's return-to-go targets (recorded
and goal-dense rewards) and the rewards' npz round trip, and the value
training CLI with its checkpoint and schedule guard.

Tiny net: dim 8, mults (1, 2), horizon 8, T = 10. Tolerances: 1e-5 for the
forward and the loss (f32 sums in another order); the gradient 1e-5 of its
largest entry; Adam's step 1e-6 (the update is lr times a ratio near +-1,
lr 1e-3), twice the learning rate where the gradient is rounding noise;
the returns 1e-6 (the same float64 accumulation, then f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dadiff_tpu.datasets import sources as jsources
from dadiff_tpu.datasets.sequence import SequenceDataset as JaxDataset
from dadiff_tpu.models.value_net import ValueNet as JaxValueNet
from dadiff_tpu.models.value_net import value_loss as jax_value_loss
from dadiff_tpu.ops.schedules import make_schedule as jax_schedule

from dadiff_tpu_torch import cli
from dadiff_tpu_torch.datasets import sources
from dadiff_tpu_torch.datasets.sequence import SequenceDataset
from dadiff_tpu_torch.io.torch_compat import value_params_from_jax
from dadiff_tpu_torch.models.value_net import ValueNet, value_loss
from dadiff_tpu_torch.ops.schedules import make_schedule

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, D, T_STEPS, BATCH = 8, 8, 10, 16
TOL = 1e-5
DATASET = "synthetic:pointmaze:n=4,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_net(seed=0):
    vnet = JaxValueNet(transition_dim=D, dim=8, dim_mults=(1, 2))
    params = jax.jit(lambda k: vnet.init_params(k, H))(jax.random.PRNGKey(seed))
    return vnet, params


def _port_net(params):
    net = ValueNet(D, dim=8, dim_mults=(1, 2))
    net.load_state_dict(value_params_from_jax(_np_tree(params)), strict=True)
    return net


def _batch(seed=0):
    ds = JaxDataset(DATASET, horizon=H, include_returns=True)
    return ds.get_batch(np.random.RandomState(seed).permutation(len(ds))[:BATCH])


def test_value_net_forward_matches_jax():
    vnet, params = _jax_net()
    rng = np.random.RandomState(1)
    x = rng.randn(4, H, D).astype(np.float32)
    t = np.array([0, 3, 7, 9])
    want = jax.jit(vnet.apply)({"params": params}, jnp.asarray(x),
                               jnp.asarray(t))
    with torch.no_grad():
        got = _port_net(params)(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _jax_draws(key, x0_shape):
    """t and the noise the JAX value_loss draws from ``key``
    (value_net.py:80-82)."""
    t_key, noise_key = jax.random.split(key)
    t = jax.random.randint(t_key, (x0_shape[0],), 0, T_STEPS)
    noise = jax.random.normal(noise_key, x0_shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def test_value_loss_grad_and_adam_step_match_jax():
    vnet, params = _jax_net()
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    sched = jax_schedule(T_STEPS, "cosine")
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(
            lambda q: jax_value_loss(vnet, q, sched, key, jbatch))(p)
        updates, _ = opt.update(grads, opt.init(p))
        return loss, grads, optax.apply_updates(p, updates)

    want_loss, want_grads, want_next = step(params)

    net = _port_net(params)
    t, noise = _jax_draws(key, batch["conditions"].shape)
    loss = value_loss(net, make_schedule(T_STEPS, "cosine"),
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      t, noise)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= TOL
    grads = value_params_from_jax(_np_tree(want_grads))
    scale = max(float(v.abs().max()) for v in grads.values())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=TOL * scale, err_msg=name)
    # Adam's first step is lr * g / (|g| + 1e-8): where |g| < 1e-6 it
    # follows g's last bits (a conv bias that feeds a one-channel-per-group
    # GroupNorm has a zero true gradient, so only rounding noise): each
    # side then steps by up to lr in either direction, and there an entry
    # is held to twice the learning rate
    lr = 1e-3
    adam = torch.optim.Adam(net.parameters(), lr=lr)
    adam.step()
    for name, v in value_params_from_jax(_np_tree(want_next)).items():
        got = dict(net.named_parameters())[name]
        atol = np.where(got.grad.abs().numpy() < 1e-6, 2.1 * lr, 1e-6)
        err = np.abs(got.detach().numpy() - v.numpy())
        assert (err <= atol).all(), (name, err.max())


@pytest.mark.parametrize("reward", ["recorded", "goal-dense"])
def test_dataset_returns_match_jax(reward):
    fn = cli.goal_dense_reward if reward == "goal-dense" else None
    kw = dict(horizon=H, include_returns=True, discount=0.9, reward_fn=fn)
    want = JaxDataset(DATASET, **kw)
    got = SequenceDataset(DATASET, **kw)
    np.testing.assert_allclose(got._returns, want._returns, atol=1e-6)
    assert got.returns_mean == pytest.approx(want.returns_mean, rel=1e-12)
    assert got.returns_std == pytest.approx(want.returns_std, rel=1e-12)
    idx = np.arange(0, len(got), 7)
    np.testing.assert_array_equal(got.get_batch(idx)["returns"],
                                  got._returns[got._starts[idx]])
    assert got[3]["returns"] == got._returns[got._starts[3]]
    np.testing.assert_allclose(got.get_batch(idx)["returns"],
                               want.get_batch(idx)["returns"], atol=1e-6)
    # padded short episodes repeat their last target
    short = SequenceDataset(episodes=sources.generate_synthetic_episodes(
        n_episodes=2, episode_len=5), horizon=H, include_returns=True)
    jshort = JaxDataset(episodes=jsources.generate_synthetic_episodes(
        n_episodes=2, episode_len=5), horizon=H, include_returns=True)
    np.testing.assert_allclose(short._returns, jshort._returns, atol=1e-6)


def test_rewards_in_sources_roundtrip(tmp_path):
    """The port's synthetic episodes carry the JAX package's rewards, and
    the npz round trip keeps them (tests/test_value.py:130)."""
    eps = sources.generate_synthetic_episodes("pointmaze", n_episodes=2,
                                              episode_len=10)
    jeps = jsources.generate_synthetic_episodes("pointmaze", n_episodes=2,
                                                episode_len=10)
    np.testing.assert_allclose(eps[0]["rewards"], jeps[0]["rewards"],
                               atol=1e-6)
    path = str(tmp_path / "r.npz")
    sources.save_episodes_npz(path, eps)
    back = sources.load_episodes_npz(path)
    np.testing.assert_array_equal(back[0]["rewards"], eps[0]["rewards"])
    np.testing.assert_array_equal(jsources.load_episodes_npz(path)[1]["rewards"],
                                  eps[1]["rewards"])


def test_train_value_main_and_checkpoint(tmp_path):
    """The CLI trains a few steps on the CPU, writes the JAX checkpoint's
    config keys, and its checkpoint loads with strict=True; a planner on
    another schedule is refused."""
    path = cli.train_value_main([
        "--dataset", DATASET, "--horizon", str(H), "--dim", "8",
        "--dim-mults", "1", "2", "--n-timesteps", str(T_STEPS),
        "--batch-size", "16", "--max-steps", "6", "--reward", "goal-dense",
        "--device", "cpu", "--log-dir", str(tmp_path)])
    ckpt = torch.load(path, weights_only=False)
    assert set(ckpt["config"]) == {
        "transition_dim", "dim", "dim_mults", "horizon", "n_timesteps",
        "beta_schedule", "returns_mean", "returns_std"}
    assert ckpt["steps"] == 6 and np.isfinite(ckpt["loss_series"]).all()
    vnet = cli.load_value_checkpoint(path, device="cpu",
                                     expect_schedule=(T_STEPS, "cosine"))
    assert not any(p.requires_grad for p in vnet.parameters())
    x = torch.randn(3, H, D)
    assert vnet(x, torch.tensor([0, 1, 2])).shape == (3,)
    with pytest.raises(SystemExit, match="retrain the value net"):
        cli.load_value_checkpoint(path, device="cpu",
                                  expect_schedule=(20, "cosine"))
    with pytest.raises(SystemExit, match="goal-concat"):
        cli.goal_dense_reward({"observations": np.zeros((3, 4)),
                               "actions": np.zeros((2, 2))})
