"""The DeepMind Control Suite adapter (port of ``sheeprl_tpu/envs/dmc.py``).

A dm_control task as one of the port's envs (``envs/wrappers.py::Env``, the
port's ``spaces``; no gymnasium): its dm_env specs concatenated into flat
``Box`` spaces, a ``[-1, 1]`` action space rescaled to the task's bounds,
a ``Dict`` observation of ``rgb`` pixels (NHWC uint8, rendered by MuJoCo)
and/or the ``state`` vector (the flattened observation, float64). An
episode's last step is a truncation when its discount is 1 (the time
limit) and a termination when it is 0. ``reset(seed)`` re-seeds the task's
``RandomState``, as the JAX adapter does.

dm_control, dm_env and mujoco are imported when the first env is built,
with ``MUJOCO_GL`` defaulting to ``egl`` (headless rendering) before the
first import. Without dm_control, building an env raises
``ModuleNotFoundError`` naming it; no other env stands in.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import Env


def dmc_available() -> bool:
    """Whether dm_control can be imported (the JAX package's
    ``_IS_DMC_AVAILABLE``)."""
    try:
        return importlib.util.find_spec("dm_control") is not None
    except (ImportError, ValueError):
        return False


def _dm_control() -> Tuple[Any, Any]:
    """dm_control's ``suite`` and dm_env's ``specs``, imported at first use."""
    if not dmc_available():
        raise ModuleNotFoundError(
            "dm_control is not installed: the DMC adapter (env=dmc, every exp=dreamer_v3_dmc_*) needs dm_control, "
            "dm_env and mujoco",
            name="dm_control",
        )
    # headless rendering by default; a display the user set up is kept
    os.environ.setdefault("MUJOCO_GL", "egl")
    from dm_control import suite
    from dm_env import specs

    return suite, specs


def _spec_to_box(spec_list: Sequence[Any], dtype: Any) -> spaces.Box:
    """dm_env array specs concatenated into one flat ``Box``: a bounded
    spec's bounds, an unbounded one's infinities."""
    _, specs = _dm_control()
    mins, maxs = [], []
    for s in spec_list:
        dim = int(np.prod(s.shape))
        if isinstance(s, specs.BoundedArray):
            mins.append(np.broadcast_to(s.minimum, (dim,)).astype(np.float32))
            maxs.append(np.broadcast_to(s.maximum, (dim,)).astype(np.float32))
        elif isinstance(s, specs.Array):
            mins.append(np.full(dim, -np.inf, dtype=np.float32))
            maxs.append(np.full(dim, np.inf, dtype=np.float32))
        else:
            raise ValueError(f"Unrecognized spec: {type(s)}")
    low = np.concatenate(mins, axis=0).astype(dtype)
    high = np.concatenate(maxs, axis=0).astype(dtype)
    return spaces.Box(low, high, dtype=dtype)


def _flatten_obs(obs: Dict[Any, Any]) -> np.ndarray:
    pieces = [np.array([v]) if np.isscalar(v) else np.asarray(v).ravel() for v in obs.values()]
    return np.concatenate(pieces, axis=0)


class DMCWrapper(Env):
    """A dm_control task with a ``Dict`` observation space (``rgb`` pixels
    and/or the ``state`` vector; see the module docstring)."""

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        from_pixels: bool = False,
        from_vectors: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        task_kwargs: Optional[Dict[Any, Any]] = None,
        environment_kwargs: Optional[Dict[Any, Any]] = None,
        visualize_reward: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        if not (from_vectors or from_pixels):
            raise ValueError(
                "'from_vectors' and 'from_pixels' must not be both False: "
                f"got {from_vectors} and {from_pixels} respectively."
            )
        suite, _ = _dm_control()
        self._from_pixels = from_pixels
        self._from_vectors = from_vectors
        self._height = height
        self._width = width
        self._camera_id = camera_id

        task_kwargs = dict(task_kwargs or {})
        task_kwargs.pop("random", None)  # reset() seeds the task
        self._env = suite.load(
            domain_name=domain_name,
            task_name=task_name,
            task_kwargs=task_kwargs,
            visualize_reward=visualize_reward,
            environment_kwargs=environment_kwargs,
        )

        self._true_action_space = _spec_to_box([self._env.action_spec()], np.float32)
        self.action_space = spaces.Box(-1.0, 1.0, shape=self._true_action_space.shape, dtype=np.float32)

        reward_space = _spec_to_box([self._env.reward_spec()], np.float32)
        self.reward_range = (reward_space.low.item(), reward_space.high.item())

        obs_space: Dict[str, spaces.Space] = {}
        if from_pixels:
            obs_space["rgb"] = spaces.Box(0, 255, (height, width, 3), np.uint8)
        if from_vectors:
            obs_space["state"] = _spec_to_box(self._env.observation_spec().values(), np.float64)
        self.observation_space = spaces.Dict(obs_space)
        self.state_space = _spec_to_box(self._env.observation_spec().values(), np.float64)

        self.current_state: Optional[np.ndarray] = None
        self.render_mode = "rgb_array"
        self.metadata = {"render_fps": 30}
        self._seed(seed)

    def _seed(self, seed: Optional[int] = None) -> None:
        self._true_action_space.seed(seed)
        self.action_space.seed(seed)
        self.observation_space.seed(seed)

    def _get_obs(self, time_step: Any) -> Dict[str, np.ndarray]:
        obs: Dict[str, np.ndarray] = {}
        if self._from_pixels:
            obs["rgb"] = self.render()
        if self._from_vectors:
            obs["state"] = _flatten_obs(time_step.observation)
        return obs

    def _convert_action(self, action: np.ndarray) -> np.ndarray:
        """Rescale ``[-1, 1]`` actions to the task's bounds."""
        action = np.asarray(action, dtype=np.float64)
        true_delta = self._true_action_space.high - self._true_action_space.low
        norm_delta = self.action_space.high - self.action_space.low
        action = (action - self.action_space.low) / norm_delta
        return (action * true_delta + self._true_action_space.low).astype(np.float32)

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        time_step = self._env.step(self._convert_action(action))
        reward = time_step.reward or 0.0
        obs = self._get_obs(time_step)
        self.current_state = _flatten_obs(time_step.observation)
        info = {"discount": time_step.discount, "internal_state": self._env.physics.get_state().copy()}
        # an episode ends at its time limit (discount 1: a truncation) or
        # by a true termination (discount 0)
        truncated = time_step.last() and time_step.discount == 1
        terminated = time_step.last() and time_step.discount == 0
        return obs, reward, terminated, truncated, info

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        if seed is not None:
            self._env.task._random = np.random.RandomState(seed)
        time_step = self._env.reset()
        self.current_state = _flatten_obs(time_step.observation)
        return self._get_obs(time_step), {}

    def render(self, camera_id: Optional[int] = None) -> np.ndarray:
        return self._env.physics.render(
            height=self._height, width=self._width, camera_id=camera_id if camera_id is not None else self._camera_id
        )

    def close(self) -> None:
        self._env.close()
