"""PixelCatcher, the self-contained pixel task (port of
``sheeprl_tpu/envs/toy.py``, on the port's own spaces).

A paddle along the bottom row catches pellets falling from random columns.
Actions: 0 = left, 1 = stay, 2 = right (or one continuous velocity in
[-1, 1]). Reward +1 for a catch, -1 for a miss, which ends the episode;
``episode_pellets`` catches truncate it. Observations are the rendered
frame only, ``{"rgb": uint8[size, size, 3]}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Env


class PixelCatcher(Env):
    def __init__(
        self,
        id: str = "pixel_catcher",
        size: int = 64,
        paddle_width: int = 12,
        paddle_speed: int = 3,
        fall_speed: int = 2,
        episode_pellets: int = 12,
        continuous_actions: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        self._size = int(size)
        self._paddle_w = int(paddle_width)
        self._paddle_speed = int(paddle_speed)
        self._fall_speed = int(fall_speed)
        self._episode_pellets = int(episode_pellets)
        self._continuous = bool(continuous_actions)
        self._rng = np.random.default_rng(seed)
        self.observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, (self._size, self._size, 3), np.uint8)})
        if self._continuous:
            self.action_space = spaces.Box(-1.0, 1.0, (1,), np.float32)
        else:
            self.action_space = spaces.Discrete(3)
        self._paddle_x = self._size // 2
        self._pellet: Tuple[int, int] = (0, 0)
        self._caught = 0
        self._dropped = 0

    def _spawn(self) -> None:
        margin = self._paddle_w // 2
        self._pellet = (int(self._rng.integers(margin, self._size - margin)), 0)

    def _frame(self) -> Dict[str, np.ndarray]:
        img = np.zeros((self._size, self._size, 3), np.uint8)
        half = self._paddle_w // 2
        lo = max(0, self._paddle_x - half)
        hi = min(self._size, self._paddle_x + half + 1)
        img[-3:, lo:hi, :] = (0, 255, 0)  # paddle: green bar, bottom rows
        px, py = self._pellet
        img[max(0, py - 2) : py + 1, max(0, px - 1) : px + 2, :] = (255, 255, 255)
        return {"rgb": img}

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle_x = self._size // 2
        self._caught = 0
        self._dropped = 0
        self._spawn()
        return self._frame(), {}

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        if self._continuous:
            vel = float(np.clip(np.asarray(action, np.float32).reshape(-1)[0], -1.0, 1.0))
            move = int(round(vel * self._paddle_speed))
        else:
            move = (int(np.asarray(action).reshape(()).item()) - 1) * self._paddle_speed
        half = self._paddle_w // 2
        self._paddle_x = int(np.clip(self._paddle_x + move, half, self._size - 1 - half))

        px, py = self._pellet
        py += self._fall_speed
        reward = 0.0
        terminated = False
        if py >= self._size - 3:  # impact at the paddle rows
            self._dropped += 1
            if abs(px - self._paddle_x) <= half:
                reward = 1.0
                self._caught += 1
            else:
                reward = -1.0
                terminated = True  # a miss ends the episode (visible in-frame)
            self._spawn()
        else:
            self._pellet = (px, py)

        truncated = not terminated and self._dropped >= self._episode_pellets
        info = {"caught": self._caught, "dropped": self._dropped}
        return self._frame(), reward, terminated, truncated, info

    def close(self) -> None:
        return
