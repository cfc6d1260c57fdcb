"""Seeded weights for the JAX models of the port's tests, from the models'
shapes alone (``jax.eval_shape``). XLA compiling a flax init takes seconds
on the CPU (~8 s for a tiny U-Net); evaluating its shapes takes ~0.1 s.

Kernels are normal with deviation 1/sqrt(the product of their leading
axes), GroupNorm scales 1 + normal(0.1), biases normal(0.1): every leaf
nonzero, so each carries signal (the transformer's zero-initialised adaLN
and output kernels too)."""

import jax
import numpy as np


def seeded_params(model, horizon: int, seed: int = 0):
    """A numpy parameter tree of ``model`` (any module with
    ``init_params(key, horizon)``) drawn from ``seed``."""
    shapes = jax.eval_shape(lambda k: model.init_params(k, horizon),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*s.shape)
        else:
            v = rng.randn(*s.shape) / np.sqrt(max(np.prod(s.shape[:-1]), 1))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
