"""Batched PointMaze as torch ops on one device: the on-device env of the
plan -> step -> replan loop (envs/rollout.py).

Counterpart of the JAX package's envs/pointmaze_jax.py: MAZE_MAPS :31,
GOAL_THRESHOLD / VELOCITY_LIMIT / AGENT_RADIUS :69-71, xy_to_cell :74,
PointMazeState :87 and PointMazeJax :97-269 (``_is_wall`` :142,
``_resolve_disc`` :153, ``reset`` :193, ``observation`` :231, ``step`` :236).
The module keeps its counterpart's name so that a reader finds it. The
semantics track gymnasium-robotics PointMaze (maps, goal threshold 0.45,
sparse or dense reward exp(-d), action clip 1, velocity clip 5) with
sysID-calibrated double-integrator physics and disc-versus-wall-box contact
(``collision="axis"``: the axis-freeze model).

Every method is a function of a :class:`PointMazeState` of float32 tensors on
the caller's device: thousands of envs step as a few dozen tensor ops, with
no transfer to the host. ``reset`` draws from a ``torch.Generator`` on that
device, or takes the start and goal positions it is given.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# gymnasium_robotics/envs/maze/maps.py layout: 1 = wall
MAZE_MAPS = {
    "umaze": [
        [1, 1, 1, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 0, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1],
    ],
    "open": [
        [1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    "medium": [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 1, 1, 0, 0, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 0, 0, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 0, 0, 1, 0, 1],
        [1, 0, 0, 0, 1, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "large": [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ],
}

GOAL_THRESHOLD = 0.45
VELOCITY_LIMIT = 5.0
AGENT_RADIUS = 0.1


def xy_to_cell(xy: torch.Tensor, H: int, W: int):
    """Physical xy -> (row, col) grid cell, origin at the maze center, y up
    and rows down; floored (negative coordinates round down), then clipped
    to the grid (pointmaze_jax.py:74-84)."""
    col = torch.floor(xy[..., 0] + W / 2.0).long().clamp(0, W - 1)
    row = torch.floor(H / 2.0 - xy[..., 1]).long().clamp(0, H - 1)
    return row, col


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed as jnp.linalg.norm does."""
    return torch.sqrt((v * v).sum(dim=-1))


class PointMazeState(NamedTuple):
    """Batched env state."""

    pos: torch.Tensor   # (B, 2) float32
    vel: torch.Tensor   # (B, 2) float32
    goal: torch.Tensor  # (B, 2) float32
    t: torch.Tensor     # (B,) int32 step counter
    done: torch.Tensor  # (B,) bool


@functools.lru_cache(maxsize=None)
def _occupancy(map_name: str, device: str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(MAZE_MAPS[map_name], np.int32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _probe_offsets(device: str) -> torch.Tensor:
    """The 4 radius-offset corners the axis contact probes, (4, 2) float32."""
    return torch.tensor([[dx, dy] for dx in (-AGENT_RADIUS, AGENT_RADIUS)
                         for dy in (-AGENT_RADIUS, AGENT_RADIUS)],
                        dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class PointMazeJax:
    """Batched point-mass maze: a static configuration whose methods are
    functions of the state (pointmaze_jax.py:97-269). Physics, sysID-fit to
    the real gymnasium-robotics PointMaze:

        v' = clip(damping * v + vel_gain * a, -5, 5),  p' = p + pos_dt * v'

    then the contact model."""

    map_name: str = "umaze"
    pos_dt: float = 0.0099
    vel_gain: float = 0.222
    damping: float = 0.9885
    reward_type: str = "sparse"  # 'sparse' | 'dense'
    continuing_task: bool = True
    max_episode_steps: int = 1000
    reset_noise: float = 0.25
    collision: str = "disc"  # 'disc' (sphere/box push-out) | 'axis'
    wall_slack: float = 0.02  # allowed penetration of the disc model

    @property
    def maze(self) -> np.ndarray:
        return np.asarray(MAZE_MAPS[self.map_name], dtype=np.int32)

    def occupancy(self, device) -> torch.Tensor:
        return _occupancy(self.map_name, str(torch.device(device)))

    def _cell_centers(self) -> np.ndarray:
        """xy centers of the free cells (pointmaze_jax.py:127-137)."""
        maze = self.maze
        H, W = maze.shape
        rows, cols = np.nonzero(maze == 0)
        x = (cols + 0.5) - W / 2.0
        y = H / 2.0 - (rows + 0.5)
        return np.stack([x, y], axis=-1).astype(np.float32)

    def _is_wall(self, xy: torch.Tensor) -> torch.Tensor:
        """Wall check at the 4 radius-offset corners (pointmaze_jax.py:142)."""
        occ = self.occupancy(xy.device)
        offsets = _probe_offsets(str(xy.device))
        row, col = xy_to_cell(xy[..., None, :] + offsets, *self.maze.shape)
        return (occ[row, col] == 1).any(dim=-1)

    def _resolve_disc(self, pos: torch.Tensor, vel: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Disc-versus-wall-box contact (pointmaze_jax.py:153-190): push the
        agent out of any wall box it overlaps deeper than ``wall_slack``
        along the minimal translation, and remove the inward normal
        velocity (the tangential part slides on). Two passes over the 9
        neighbour boxes, each box applied in turn."""
        occ = self.occupancy(pos.device)
        Hm, Wm = self.maze.shape
        reach = AGENT_RADIUS - self.wall_slack
        for _ in range(2):
            row, col = xy_to_cell(pos, Hm, Wm)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    r_ = (row + dr).clamp(0, Hm - 1)
                    c_ = (col + dc).clamp(0, Wm - 1)
                    is_w = occ[r_, c_] == 1
                    lo = torch.stack([c_ - Wm / 2.0, Hm / 2.0 - (r_ + 1)],
                                     dim=-1).to(pos.dtype)
                    q = torch.minimum(torch.maximum(pos, lo), lo + 1.0)
                    d = pos - q
                    dist = _norm(d)
                    pen = reach - dist
                    hit = is_w & (pen > 0) & (dist > 1e-9)
                    n = d / torch.clamp(dist, min=1e-9)[..., None]
                    pos = torch.where(hit[..., None], pos + n * pen[..., None],
                                      pos)
                    vn = (vel * n).sum(dim=-1)
                    kill = hit & (vn < 0)
                    vel = torch.where(kill[..., None], vel - vn[..., None] * n,
                                      vel)
        return pos, vel

    # -- API -------------------------------------------------------------------
    def reset(self, generator: Optional[torch.Generator], batch_size: int = 1,
              device=None, *, pos: Optional[torch.Tensor] = None,
              goal: Optional[torch.Tensor] = None
              ) -> Tuple[PointMazeState, torch.Tensor]:
        """Start and goal uniform over the free cells, in distinct cells, each
        plus uniform noise of +-``reset_noise`` (pointmaze_jax.py:193-229);
        or the given ``pos`` and ``goal`` (B, 2). ``device``: the
        generator's, by default."""
        if device is None:
            device = generator.device if generator is not None else "cpu"
        if pos is None or goal is None:
            centers = torch.as_tensor(self._cell_centers(), device=device)
            n_cells = centers.shape[0]
            kw = dict(generator=generator, device=device)
            start_idx = torch.randint(0, n_cells, (batch_size,), **kw)
            goal_idx = (start_idx + torch.randint(1, n_cells, (batch_size,),
                                                  **kw)) % n_cells
            r = self.reset_noise
            pos = centers[start_idx] + (
                torch.rand(batch_size, 2, **kw) * (2 * r) - r)
            goal = centers[goal_idx] + (
                torch.rand(batch_size, 2, **kw) * (2 * r) - r)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
        goal = torch.as_tensor(goal, dtype=torch.float32, device=device)
        B = pos.shape[0]
        state = PointMazeState(
            pos=pos, vel=torch.zeros(B, 2, device=device), goal=goal,
            t=torch.zeros(B, dtype=torch.int32, device=device),
            done=torch.zeros(B, dtype=torch.bool, device=device))
        return state, self.observation(state)

    def observation(self, state: PointMazeState) -> torch.Tensor:
        """Goal-conditioned obs [x, y, vx, vy, gx, gy], the layout the data
        layer trains on (pointmaze_jax.py:231-234)."""
        return torch.cat([state.pos, state.vel, state.goal], dim=-1)

    def step(self, state: PointMazeState, action: torch.Tensor
             ) -> Tuple[PointMazeState, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """One physics step: (state, obs, reward, done)
        (pointmaze_jax.py:236-269)."""
        a = action.clamp(-1.0, 1.0)
        vel = (self.damping * state.vel + a * self.vel_gain).clamp(
            -VELOCITY_LIMIT, VELOCITY_LIMIT)
        if self.collision == "disc":
            pos, vel = self._resolve_disc(state.pos + vel * self.pos_dt, vel)
        else:
            # axis-separated: a blocked axis stops (its velocity zeroed)
            zero = torch.zeros_like(vel[..., 0])
            pos_x_try = state.pos + torch.stack(
                [vel[..., 0] * self.pos_dt, zero], dim=-1)
            hit_x = self._is_wall(pos_x_try)
            pos_x = torch.where(hit_x[..., None], state.pos, pos_x_try)
            vel = torch.stack([torch.where(hit_x, 0.0, vel[..., 0]),
                               vel[..., 1]], dim=-1)
            pos_y_try = pos_x + torch.stack(
                [zero, vel[..., 1] * self.pos_dt], dim=-1)
            hit_y = self._is_wall(pos_y_try)
            pos = torch.where(hit_y[..., None], pos_x, pos_y_try)
            vel = torch.stack([vel[..., 0],
                               torch.where(hit_y, 0.0, vel[..., 1])], dim=-1)

        dist = _norm(pos - state.goal)
        success = dist <= GOAL_THRESHOLD
        if self.reward_type == "dense":
            reward = torch.exp(-dist)
        else:
            reward = success.to(torch.float32)

        t = state.t + 1
        terminated = torch.zeros_like(success) if self.continuing_task \
            else success
        done = state.done | terminated | (t >= self.max_episode_steps)
        new_state = PointMazeState(pos=pos, vel=vel, goal=state.goal, t=t,
                                   done=done)
        return new_state, self.observation(new_state), reward, done
