"""Fake environments for the mlp-key path (port of the discrete,
multi-discrete and continuous envs of ``sheeprl_tpu/envs/dummy.py``). The obs dict holds
``rgb`` (NHWC uint8) and ``state`` (float32), both encoding the step index;
episodes end via ``terminated`` after ``n_steps``."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Env


class BaseDummyEnv(Env):
    def __init__(
        self, image_size: Tuple[int, int, int] = (64, 64, 3), n_steps: int = 128, vector_shape: Tuple[int, ...] = (10,)
    ) -> None:
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, image_size, np.uint8),
                "state": spaces.Box(-20, 20, vector_shape, np.float32),
            }
        )
        self._current_step = 0
        self._n_steps = n_steps

    def get_obs(self) -> Dict[str, np.ndarray]:
        return {
            "rgb": np.full(self.observation_space["rgb"].shape, self._current_step % 256, dtype=np.uint8),
            "state": np.full(self.observation_space["state"].shape, self._current_step, dtype=np.float32),
        }

    def step(self, action):
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self.get_obs(), 0.0, done, False, {}

    def reset(self, seed=None, options=None):
        self._current_step = 0
        return self.get_obs(), {}

    def close(self):
        pass


class ContinuousDummyEnv(BaseDummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 128, vector_shape=(10,), action_dim: int = 2) -> None:
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape)
        self.action_space = spaces.Box(-np.inf, np.inf, (action_dim,), np.float32)


class DiscreteDummyEnv(BaseDummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 4, vector_shape=(10,), action_dim: int = 2) -> None:
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape)
        self.action_space = spaces.Discrete(action_dim)


class MultiDiscreteDummyEnv(BaseDummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 128, vector_shape=(10,), action_dims: Sequence[int] = (2, 2)) -> None:
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape)
        self.action_space = spaces.MultiDiscrete(list(action_dims))


def get_dummy_env(id: str, **kwargs) -> BaseDummyEnv:
    """Select a dummy env by id substring."""
    if "continuous" in id:
        return ContinuousDummyEnv(**kwargs)
    if "multidiscrete" in id:
        return MultiDiscreteDummyEnv(**kwargs)
    if "discrete" in id:
        return DiscreteDummyEnv(**kwargs)
    raise ValueError(f"Unrecognized dummy environment: {id}")
