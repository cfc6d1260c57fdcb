"""What the benchmark makes from ``--seed`` and hands to both the port and
the reference: the weights, the observations, the env starts and the
arrival schedule. Nothing here imports the port.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from portbench import spec
from portbench.spec import PKG, REPO, rng, subseed

# the key of the one arrival pattern every seed of a cell is offered
DESIGN_SEED = 20


def model_specs(cfg, pkg=PKG) -> List[tuple]:
    """The denoiser's weights as its family's reference names them."""
    return spec.reference(cfg, pkg).param_specs(cfg)


def make_weights(cfg, seed: int, device,
                 pkg=PKG) -> "OrderedDict[str, object]":
    """Every weight of the denoiser, float32 on ``device``, drawn from the
    seed on the device in two calls (one uniform, one normal), at PyTorch's
    default initialisation of each layer."""
    import torch

    specs = model_specs(cfg, pkg)
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    sizes = [int(np.prod(s)) for _, s, init, _ in specs if init == "uniform"]
    uni = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    nsize = sum(int(np.prod(s)) for _, s, init, _ in specs
                if init == "normal02")
    nor = torch.randn(max(nsize, 1), generator=g, device=device) * 0.02
    out, u, n = OrderedDict(), 0, 0
    for name, shape, init, fan_in in specs:
        size = int(np.prod(shape))
        if init == "uniform":
            out[name] = (uni[u:u + size] / float(np.sqrt(fan_in))).reshape(
                shape).clone()
            u += size
        elif init == "normal02":
            out[name] = nor[n:n + size].reshape(shape).clone()
            n += size
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def dataset_path(cfg) -> str:
    return str(REPO / cfg["dataset"])


def observation_pool(cfg, seed: int, n: int) -> np.ndarray:
    """``n`` observations drawn, with replacement, from every observation
    of the data file (float32, (n, obs_dim))."""
    with np.load(dataset_path(cfg)) as data:
        obs = np.concatenate([data[f"obs_{i}"]
                              for i in range(int(data["n_episodes"]))])
    idx = rng(seed, "observations").integers(0, len(obs), size=n)
    return np.asarray(obs[idx], np.float32)


def maze_starts(maze, seed: int, episodes: int, batch: int,
                noise: float = 0.25) -> Dict[str, np.ndarray]:
    """Start and goal of every env of every episode: uniform over the free
    cells, in distinct cells, each plus uniform noise of +-``noise``
    (gymnasium-robotics' reset), float32 (episodes, batch, 2)."""
    from portbench.reference.maze import cell_centers

    centers = cell_centers(maze)
    n = len(centers)
    r = rng(seed, "starts")
    start = r.integers(0, n, size=(episodes, batch))
    goal = (start + r.integers(1, n, size=(episodes, batch))) % n
    jit = r.uniform(-noise, noise, size=(2, episodes, batch, 2))
    return {"pos": (centers[start] + jit[0]).astype(np.float32),
            "goal": (centers[goal] + jit[1]).astype(np.float32)}


def exponential_gaps(rate: float, seconds: float) -> np.ndarray:
    """The gaps of a Poisson stream at ``rate`` over ``seconds``, as the
    quantiles of the exponential at the midpoints of n equal slices
    (n = rate x seconds): every seed gets this same set of gaps, in its own
    order."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def arrival_schedule(seed: int, controllers: int, rate: float,
                     seconds: float) -> List[np.ndarray]:
    """Each controller's due times (s from the window's start) at a total
    ``rate``. The cell's arrival pattern is one fixed sample: controller
    k's share of the gaps in the order that the design key draws for k,
    accumulated; the seed deals these sequences to the controllers in its
    own order. Every seed so offers the server the same arrivals (the
    tail of a few hundred requests otherwise moves with where a seed's
    arrivals happen to bunch). Due times at or after ``seconds`` are
    dropped."""
    gaps = exponential_gaps(rate / controllers, seconds)
    base = [np.cumsum(rng(DESIGN_SEED, "arrivals", k).permutation(gaps))
            for k in range(controllers)]
    order = rng(seed, "arrivals").permutation(controllers)
    return [base[k][base[k] < seconds] for k in order]
