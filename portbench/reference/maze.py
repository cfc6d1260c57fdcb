"""PointMaze as plain tensor operations: the double-integrator physics fit
to gymnasium-robotics' PointMaze, v' = clip(d v + g a, -5, 5),
p' = p + dt v', with the agent a disc of radius 0.1 pushed out of the wall
boxes it overlaps deeper than a slack, its inward normal velocity removed.

``dtype`` is the precision of the arithmetic (float32 as stated; the
control computes it in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

GOAL_THRESHOLD = 0.45
VELOCITY_LIMIT = 5.0
AGENT_RADIUS = 0.1

UMAZE = [[1, 1, 1, 1, 1],
         [1, 0, 0, 0, 1],
         [1, 1, 1, 0, 1],
         [1, 0, 0, 0, 1],
         [1, 1, 1, 1, 1]]


def cell_centers(maze) -> np.ndarray:
    """xy centres of the free cells: origin at the maze's centre, y up."""
    maze = np.asarray(maze)
    H, W = maze.shape
    rows, cols = np.nonzero(maze == 0)
    return np.stack([(cols + 0.5) - W / 2.0, H / 2.0 - (rows + 0.5)],
                    axis=-1).astype(np.float32)


def _cell(xy, H, W):
    col = torch.floor(xy[..., 0] + W / 2.0).long().clamp(0, W - 1)
    row = torch.floor(H / 2.0 - xy[..., 1]).long().clamp(0, H - 1)
    return row, col


def _norm(v):
    return torch.sqrt((v * v).sum(dim=-1))


def step(pos, vel, action, maze, *, pos_dt=0.0099, vel_gain=0.222,
         damping=0.9885, wall_slack=0.02, dtype=torch.float32):
    """One step of every env: (pos, vel) after ``action`` (B, 2)."""
    out = pos.dtype
    pos, vel, action = pos.to(dtype), vel.to(dtype), action.to(dtype)
    occ = torch.as_tensor(np.asarray(maze, np.int32), device=pos.device)
    Hm, Wm = occ.shape
    a = action.clamp(-1.0, 1.0)
    vel = (damping * vel + a * vel_gain).clamp(-VELOCITY_LIMIT,
                                               VELOCITY_LIMIT)
    pos = pos + vel * pos_dt
    reach = AGENT_RADIUS - wall_slack
    for _ in range(2):
        row, col = _cell(pos, Hm, Wm)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                r_ = (row + dr).clamp(0, Hm - 1)
                c_ = (col + dc).clamp(0, Wm - 1)
                wall = occ[r_, c_] == 1
                lo = torch.stack([c_ - Wm / 2.0, Hm / 2.0 - (r_ + 1)],
                                 dim=-1).to(dtype)
                q = torch.minimum(torch.maximum(pos, lo), lo + 1.0)
                d = pos - q
                dist = _norm(d)
                pen = reach - dist
                hit = wall & (pen > 0) & (dist > 1e-9)
                n = d / torch.clamp(dist, min=1e-9)[..., None]
                pos = torch.where(hit[..., None], pos + n * pen[..., None],
                                  pos)
                vn = (vel * n).sum(dim=-1)
                kill = hit & (vn < 0)
                vel = torch.where(kill[..., None], vel - vn[..., None] * n,
                                  vel)
    return pos.to(out), vel.to(out)
