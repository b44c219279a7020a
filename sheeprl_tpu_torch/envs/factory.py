"""Env construction (the part of ``sheeprl_tpu/envs/factory.py::make_env``
that the ported envs need): PixelCatcher and the dummy envs, already Dict
observation envs at the configured screen size, plus the ``TimeLimit`` of
``env.max_episode_steps``. Resizing, grayscale, frame stacks and video are
not ported: a config that asks for them raises."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.envs.dummy import get_dummy_env
from sheeprl_tpu_torch.envs.toy import PixelCatcher


class TimeLimit:
    """Truncates an episode after ``max_episode_steps`` steps."""

    def __init__(self, env: Any, max_episode_steps: int) -> None:
        self.env = env
        self.max_episode_steps = int(max_episode_steps)
        self._elapsed = 0

    def __getattr__(self, name: str) -> Any:
        return getattr(self.env, name)

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self.max_episode_steps, info


def make_env(cfg: Dict[str, Any], seed: Optional[int]) -> Callable[[], Any]:
    """A thunk that builds the configured env, seeded like the JAX factory."""

    def thunk() -> Any:
        env_cfg = cfg["env"]
        env_id = str(env_cfg["id"])
        screen = int(env_cfg["screen_size"])
        if int(env_cfg.get("frame_stack", 1)) > 1 or env_cfg.get("grayscale", False):
            raise NotImplementedError("frame stacking and grayscale are not ported yet")
        if env_id == "pixel_catcher":
            env = PixelCatcher(id=env_id, size=screen, seed=seed)
        elif "dummy" in env_id:
            env = get_dummy_env(env_id, image_size=(screen, screen, 3))
        else:
            raise NotImplementedError(f"env {env_id!r} is not ported yet")
        for k in cfg["algo"]["cnn_keys"]["encoder"]:
            if env.observation_space[k].shape[:2] != (screen, screen):
                raise NotImplementedError(f"image key {k!r} is not {screen}x{screen}; resizing is not ported yet")
        steps = env_cfg.get("max_episode_steps")
        if steps and int(steps) > 0:
            env = TimeLimit(env, int(steps))
        return env

    return thunk
