"""The DMC variants with synthetic distractor observations (port of
``sheeprl_tpu/envs/dmc_variants.py``):

- :class:`DMC64Wrapper`: 64x64 ``camera_rgb`` and ``camera_depth`` noise
  images beside the task's observations;
- :class:`DMCExtendedWrapper`: a ``random_img`` noise image the size of the
  pixel stream, a 10-value ``random_values`` vector and a
  ``combined_values`` scalar, the first pixel plus the first state entry.

The noise is drawn from numpy's global generator (``np.random``), as the
JAX variants draw it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dmc import DMCWrapper


class DMC64Wrapper(DMCWrapper):
    _CAM_HW = 64

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        if self._from_pixels:
            shape = (self._CAM_HW, self._CAM_HW, 1)
            obs_space = dict(self.observation_space.spaces)
            obs_space["camera_rgb"] = spaces.Box(0, 255, shape, np.uint8)
            obs_space["camera_depth"] = spaces.Box(0, 255, shape, np.uint8)
            self.observation_space = spaces.Dict(obs_space)

    def _get_obs(self, time_step: Any) -> Dict[str, np.ndarray]:
        obs = super()._get_obs(time_step)
        if self._from_pixels:
            shape = (self._CAM_HW, self._CAM_HW, 1)
            obs["camera_rgb"] = np.random.randint(0, 256, size=shape, dtype=np.uint8)
            obs["camera_depth"] = np.random.randint(0, 256, size=shape, dtype=np.uint8)
        return obs


class DMCExtendedWrapper(DMCWrapper):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        obs_space = dict(self.observation_space.spaces)
        if self._from_pixels:
            obs_space["random_img"] = spaces.Box(0, 255, obs_space["rgb"].shape, np.uint8)
            obs_space["random_values"] = spaces.Box(0, 1, (10,), np.float32)
        if self._from_pixels and self._from_vectors:
            obs_space["combined_values"] = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        self.observation_space = spaces.Dict(obs_space)

    def _get_obs(self, time_step: Any) -> Dict[str, np.ndarray]:
        obs = super()._get_obs(time_step)
        if self._from_pixels:
            obs["random_img"] = np.random.randint(0, 256, size=obs["rgb"].shape, dtype=np.uint8)
            obs["random_values"] = np.random.random(size=10).astype(np.float32)
        if self._from_pixels and self._from_vectors:
            obs["combined_values"] = np.array([float(obs["rgb"][0, 0, 0]) + float(obs["state"][0])], dtype=np.float32)
        return obs
