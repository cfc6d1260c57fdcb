"""The port under test, built from a configuration and the benchmark's
inputs through its own entry points: the denoiser and GaussianDiffusion,
the dataset normaliser and the identified dynamics, the served policy
wired to the K2 planner chain, the on-device evaluator.

The benchmark adds no code to the timed path. Around the port's calls it
puts its own spans (``portbench.wave.c<chains>``, read by the trace) and
its own records: a subclass of the port's ``BatchedPlanner`` that keeps
its instance, seeds each session from the run's seed and names each wave,
a subclass of the server's request counter that ends the accept loop when
the window is over, and a maze env whose ``step`` keeps what it was given
and returned.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import List

import torch

from portbench import spec
from portbench.inputs import dataset_path
from portbench.spec import PKG, subseed

ENV_NAME = "PointMaze_UMaze-v3"
WAVE = "portbench.wave.c"


def k2(cfg, pkg=PKG) -> bool:
    """Whether the configuration's family plans on K2."""
    return spec.family(cfg, pkg).PLANNER == "k2"


def load_kernels(cfg, device, pkg=PKG) -> None:
    """Load (build on the first run in a checkout) the CUDA libraries of
    the configuration's path; on the CPU the port runs their plain
    versions."""
    if k2(cfg, pkg) and device.type == "cuda":
        from dadiff_tpu_torch.ops import cuda_lib

        cuda_lib.lib("planner")


def diffusion(cfg, weights, device, pkg=PKG):
    """The port's GaussianDiffusion around its family's denoiser, with the
    benchmark's weights."""
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion

    with torch.device(device):
        model = spec.family(cfg, pkg).denoiser(cfg)
    model.load_state_dict(weights, strict=True)
    diff = GaussianDiffusion(
        model, horizon=cfg["horizon"],
        observation_dim=cfg["observation_dim"],
        action_dim=cfg["action_dim"], n_timesteps=cfg["n_timesteps"],
        beta_schedule=cfg["beta_schedule"],
        predict_epsilon=cfg["predict_epsilon"],
        clip_denoised=cfg["clip_denoised"])
    return diff.to(device).eval()


@dataclasses.dataclass
class Data:
    normalizer: object
    stats: object      # NormStats on the device
    P: torch.Tensor    # float32 projector on the device
    state_dim: int


def data(cfg, device) -> Data:
    """The normaliser and the projector, as the port's evaluate and serve
    CLIs derive them from the data file."""
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset
    from dadiff_tpu_torch.datasets.sources import load_episodes
    from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
    from dadiff_tpu_torch.dynamics.registry import get_dynamics_for_env
    from dadiff_tpu_torch.ops.projection import NormStats

    spec = "npz:" + dataset_path(cfg)
    episodes = load_episodes(spec)
    dataset = SequenceDataset(dataset_name=spec, horizon=cfg["horizon"],
                              normalizer="LimitsNormalizer",
                              max_path_length=1000, use_padding=True,
                              episodes=episodes)
    A, B, state_dim, action_dim = get_dynamics_for_env(ENV_NAME,
                                                       episodes=episodes)
    P = ProjectionMatrixBuilder(A, B, state_dim, action_dim
                                ).get_projection_matrix(cfg["horizon"])
    return Data(dataset.normalizer,
                NormStats.from_normalizer(dataset.normalizer, device),
                torch.as_tensor(P, dtype=torch.float32, device=device),
                state_dim)


def served_policy(cfg, diff, d: Data, seed: int):
    """The dynamics-aware bo-N policy the serve CLI builds with
    ``--policy-type dynamics-aware --n-candidates N --megakernel``."""
    from dadiff_tpu_torch.guides.policies import DynamicsAwarePolicy
    from dadiff_tpu_torch.ops.planner import wire_policy_megakernel

    policy = DynamicsAwarePolicy(
        diff, projection_matrix=d.P.cpu().numpy(), normalizer=d.normalizer,
        state_dim=d.state_dim, projection_schedule=cfg["projection_schedule"],
        action_horizon=cfg["action_horizon"],
        sampling_timesteps=cfg["n_timesteps"], seed=subseed(seed, "policy"),
        n_candidates=cfg["n_candidates"])
    return wire_policy_megakernel(policy, n_candidates=cfg["n_candidates"])


class ServerHooks:
    """Install the benchmark's subclasses into the port's serve and serving
    modules for one run; ``restore`` puts the port's classes back."""

    def __init__(self, seed: int, n_candidates: int):
        import dadiff_tpu_torch.serve as serve_mod
        import dadiff_tpu_torch.serving as serving_mod

        self.serve_mod, self.serving_mod = serve_mod, serving_mod
        self.saved = (serving_mod.BatchedPlanner, serve_mod._Counter)
        self.batchers: List[object] = []
        self.stop = threading.Event()
        # tracing: from the first wave at or after ``trace_at`` (perf
        # counter), ``trace_waves`` waves, on the batcher's own thread
        self.tracer, self.trace_at, self.trace_waves = None, None, 0
        self.traced, self.trace_done = 0, threading.Event()
        hooks = self
        base_batcher, base_counter = self.saved

        class RecordingBatcher(base_batcher):
            def __init__(self, policy, **kw):
                hooks.batchers.append(self)
                super().__init__(policy, **kw)

            def session(self, seed: int = 0):
                return super().session(seed=session_seed(hooks.seed, seed))

            def _call(self, lanes):
                tracing = hooks.tracing_wave()
                with torch.profiler.record_function(
                        f"{WAVE}{len(lanes) * hooks.n_candidates}"):
                    out = super()._call(lanes)
                if tracing:
                    hooks.traced_wave()
                return out

        class StoppableCounter(base_counter):
            def done(self) -> bool:
                return hooks.stop.is_set() or super().done()

        self.seed, self.n_candidates = seed, n_candidates
        serving_mod.BatchedPlanner = RecordingBatcher
        serve_mod._Counter = StoppableCounter

    def tracing_wave(self) -> bool:
        """True when the wave about to run is traced (starting the trace
        at the first one)."""
        if self.tracer is None or self.trace_at is None or \
                self.trace_done.is_set():
            return False
        if self.traced == 0:
            if time.perf_counter() < self.trace_at:
                return False
            self.tracer.start()
        return True

    def traced_wave(self) -> None:
        self.traced += 1
        if self.traced >= self.trace_waves:
            self.tracer.stop()
            self.trace_done.set()

    def restore(self) -> None:
        self.serving_mod.BatchedPlanner, self.serve_mod._Counter = self.saved


def session_seed(seed: int, index: int) -> int:
    """The generator seed of the server's ``index``-th session."""
    return subseed(seed, "session", index)


def maze(cfg):
    """The port's on-device maze, keeping every step it takes in ``log``:
    (state before, action, state after)."""
    from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax

    @dataclasses.dataclass(frozen=True)
    class RecordingMaze(PointMazeJax):
        log: list = dataclasses.field(default_factory=list, compare=False,
                                      hash=False, repr=False)

        def step(self, state, action):
            out = super().step(state, action)
            self.log.append((state, action, out[0]))
            return out

    env = cfg["env"]
    return RecordingMaze(map_name=env["map"], collision=env["collision"],
                         wall_slack=env["wall_slack"])


def annotate_planner():
    """Put a ``portbench.wave.c<chains>`` span around every call of the
    planner-chain sampler that ``make_ondevice_evaluator`` builds; returns
    the function that takes it away."""
    import dadiff_tpu_torch.ops.planner as planner_mod

    base = planner_mod.make_bo_sampler

    @functools.wraps(base)
    def make_bo_sampler(*args, **kw):
        plan = base(*args, **kw)

        @functools.wraps(plan)
        def named(generator, conditions, prepared=None, **k2):
            values = conditions[0]
            n = (values.shape[0] if values.dim() == 3 else 1) \
                * kw["n_candidates"]
            group = min(kw.get("group_chains", 64), n)
            with torch.profiler.record_function(
                    f"{WAVE}{-(-n // group) * group}"):
                return plan(generator, conditions, prepared, **k2)

        return named

    planner_mod.make_bo_sampler = make_bo_sampler
    return lambda: setattr(planner_mod, "make_bo_sampler", base)


def evaluator(cfg, diff, env, d: Data, n_replans: int, pkg=PKG):
    """The port's on-device evaluator at the protocol of the cell."""
    from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
    from dadiff_tpu_torch.guides.sampling import ProjectionSpec

    return make_ondevice_evaluator(
        diff, env, action_horizon=cfg["action_horizon"], n_replans=n_replans,
        projection=ProjectionSpec(state_dim=d.state_dim,
                                  schedule=cfg["projection_schedule"]),
        n_candidates=cfg["n_candidates"],
        use_megakernel=k2(cfg, pkg), P=d.P, stats=d.stats,
        mega_group_chains=64)
