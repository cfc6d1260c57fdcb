"""Waypoint expert for maze data collection.

Counterpart of the JAX package's envs/expert.py (WaypointController :20,
collect_expert_episodes :172): BFS shortest path over free cells and PD
control toward the next waypoint, the controller that made D4RL's maze
datasets, regenerating such data where minari is absent. The controller is
numpy; collecting steps the host gymnasium PointMaze, imported inside
:func:`collect_expert_episodes`.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np



class WaypointController:
    """BFS-over-cells waypoint follower with PD control.

    Args:
        maze_map: 2-D 0/1 grid (1 = wall), e.g. envs.pointmaze_jax
            MAZE_MAPS['umaze'] or
            ``env.unwrapped.maze.maze_map``.
        p_gain / d_gain: PD gains on position error / velocity.
        waypoint_threshold: switch to the next waypoint within this distance.
    """

    def __init__(
        self,
        maze_map: Sequence[Sequence[int]],
        p_gain: float = 10.0,
        d_gain: float = -1.0,
        waypoint_threshold: float = 0.25,
        noise: float = 0.0,
        seed: int = 0,
        corner_safe: bool = False,
        lookahead: bool = False,
    ):
        self.maze = np.asarray(maze_map, dtype=np.int32)
        self.H, self.W = self.maze.shape
        self.p_gain = p_gain
        self.d_gain = d_gain
        self.waypoint_threshold = waypoint_threshold
        self.noise = noise
        self.corner_safe = corner_safe
        self.lookahead = lookahead
        self._rng = np.random.RandomState(seed)
        self._path: List[np.ndarray] = []
        self._turn: List[bool] = []
        self._goal: Optional[np.ndarray] = None

    # -- coordinate transforms (gymnasium-robotics convention) ---------------
    def _xy_to_cell(self, xy: np.ndarray) -> Tuple[int, int]:
        col = int(np.clip(np.floor(xy[0] + self.W / 2.0), 0, self.W - 1))
        row = int(np.clip(np.floor(self.H / 2.0 - xy[1]), 0, self.H - 1))
        return row, col

    def _cell_to_xy(self, cell: Tuple[int, int]) -> np.ndarray:
        row, col = cell
        return np.array(
            [(col + 0.5) - self.W / 2.0, self.H / 2.0 - (row + 0.5)], np.float64
        )

    def _bfs_path(
        self, start: Tuple[int, int], goal: Tuple[int, int]
    ) -> List[Tuple[int, int]]:
        """Shortest 4-connected path over free cells."""
        if start == goal:
            return [goal]
        prev: Dict[Tuple[int, int], Tuple[int, int]] = {start: start}
        queue = deque([start])
        while queue:
            cell = queue.popleft()
            if cell == goal:
                break
            r, c = cell
            for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                if (
                    0 <= nr < self.H
                    and 0 <= nc < self.W
                    and self.maze[nr, nc] == 0
                    and (nr, nc) not in prev
                ):
                    prev[(nr, nc)] = cell
                    queue.append((nr, nc))
        if goal not in prev:
            return [goal]  # unreachable: steer straight at it
        path = [goal]
        while path[-1] != start:
            path.append(prev[path[-1]])
        return list(reversed(path))

    def _plan(self, pos: np.ndarray, goal: np.ndarray) -> None:
        cells = self._bfs_path(self._xy_to_cell(pos), self._xy_to_cell(goal))
        xys = [self._cell_to_xy(c) for c in cells]
        turns = [False] * len(xys)
        for i in range(1, len(xys) - 1):
            d_in = xys[i] - xys[i - 1]
            d_out = xys[i + 1] - xys[i]
            if abs(float(np.dot(d_in, d_out))) < 1e-9:  # 90° turn
                turns[i] = True
                if self.corner_safe:
                    # The straight cut from the previous to the next cell
                    # center passes exactly through the inner wall corner;
                    # offset the turn waypoint away from that corner so noisy
                    # execution keeps clearance, and (in get_action) switch
                    # waypoints later there.
                    away = d_in - d_out
                    xys[i] = xys[i] + 0.2 * away / np.linalg.norm(away)
        self._path = xys[1:]
        self._turn = turns[1:]
        self._path.append(np.asarray(goal, np.float64))
        self._turn.append(False)
        self._goal = np.asarray(goal, np.float64)

    def get_action(self, obs) -> np.ndarray:
        """PD action toward the current waypoint. ``obs`` is a PointMaze dict
        observation or a flat [x, y, vx, vy, gx, gy] array."""
        if isinstance(obs, dict):
            state = np.asarray(obs["observation"], np.float64)
            goal = np.asarray(obs["desired_goal"], np.float64)
        else:
            obs = np.asarray(obs, np.float64).ravel()
            state, goal = obs[:4], obs[4:6]
        pos, vel = state[:2], state[2:4]

        if self._goal is None or np.linalg.norm(goal - self._goal) > 1e-9:
            self._plan(pos, goal)

        while len(self._path) > 1 and np.linalg.norm(self._path[0] - pos) < (
            0.15
            if (self.corner_safe and self._turn and self._turn[0])
            else self.waypoint_threshold
        ):
            self._path.pop(0)
            if self._turn:
                self._turn.pop(0)
        if self.lookahead:
            # Skip straight-run waypoints (turn flags are a property of the
            # planned path, robust to the agent's lateral offset): target
            # the next turn or the goal directly, removing the PD
            # deceleration at intermediate cell centers. Never skips a turn
            # waypoint, and only while still moving toward the waypoint.
            while (
                len(self._path) > 1
                and self._turn
                and not self._turn[0]
                and float(
                    np.dot(self._path[1] - self._path[0], self._path[0] - pos)
                ) > 0.0
            ):
                self._path.pop(0)
                self._turn.pop(0)
        target = self._path[0] if self._path else goal

        action = self.p_gain * (target - pos) + self.d_gain * vel
        if self.noise > 0:
            action = action + self._rng.normal(0, self.noise, 2)
        return np.clip(action, -1.0, 1.0).astype(np.float32)

    def reset(self) -> None:
        self._path = []
        self._turn = []
        self._goal = None


def collect_expert_episodes(
    env_name: str = "PointMaze_UMaze-v3",
    n_episodes: int = 100,
    max_steps: int = 300,
    seed: int = 0,
    noise: float = 0.2,
    continuing_task: bool = False,
    corner_safe: bool = False,
    lookahead: bool = False,
) -> List[Dict[str, np.ndarray]]:
    """Collect waypoint-expert episodes from the host env into the canonical
    episode format (the hermetic replacement for minari downloads)."""
    import gymnasium as gym

    try:
        import gymnasium_robotics  # noqa: F401
    except ImportError:
        pass

    from dadiff_tpu_torch.datasets.sources import flatten_observation

    env = gym.make(env_name, continuing_task=continuing_task)
    maze_map = env.unwrapped.maze.maze_map
    controller = WaypointController(
        maze_map, noise=noise, seed=seed, corner_safe=corner_safe,
        lookahead=lookahead,
    )

    episodes = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        controller.reset()
        obs_list = [flatten_observation(obs)]
        act_list, rew_list = [], []
        for _ in range(max_steps):
            action = controller.get_action(obs)
            obs, reward, terminated, truncated, _ = env.step(action)
            obs_list.append(flatten_observation(obs))
            act_list.append(action)
            rew_list.append(float(reward))
            if terminated or truncated:
                break
        episodes.append(
            {
                "observations": np.stack(obs_list).astype(np.float32),
                "actions": np.stack(act_list).astype(np.float32),
                "rewards": np.asarray(rew_list, dtype=np.float32),
            }
        )
    env.close()
    return episodes
