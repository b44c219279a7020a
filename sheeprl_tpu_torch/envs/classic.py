"""Host ``CartPole-v1`` and ``Pendulum-v1`` without gymnasium, over the
torch twins of ``envs/jittable.py``.

``ClassicControlEnv(id)`` is one env with the gym API: ``reset`` draws the
initial state from a ``torch.Generator`` seeded by ``reset(seed=...)``,
``step`` runs the twin's transition on a batch of one on the CPU. As
gymnasium's raw envs, it never truncates: ``make_classic_env`` wraps it in
``TimeLimit`` at the step limit gymnasium's registry sets (500 for
CartPole-v1, 200 for Pendulum-v1), as ``gymnasium.make`` does. The spaces
are gymnasium's. The dynamics are float32 where gymnasium's run in float64,
so a state agrees to float32 rounding; CartPole's rewards are exact and
Pendulum's agree to float32 rounding.

``render()`` draws gymnasium's frames (600x400 for CartPole, 500x500 for
Pendulum, ``rgb_array``) from the env's state with the port's own numpy
rasterizer (``envs/render.py``), which holds them to gymnasium's pygame
frames pixel for pixel; Pendulum keeps the last clipped torque,
``last_u``, ``None`` after a reset, for its arrow, as gymnasium does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import render as _render
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.jittable import JittableEnvSpec, State, get_jittable_env
from sheeprl_tpu_torch.envs.wrappers import Env, EnvSpec, TimeLimit

# gymnasium's registry: (max_episode_steps, observation bounds, action space)
_CARTPOLE_HIGH = np.array([2.4 * 2, np.inf, 12 * 2 * math.pi / 360 * 2, np.inf], dtype=np.float32)
CLASSIC_ENVS: Dict[str, Dict[str, Any]] = {
    "CartPole-v1": {
        "max_episode_steps": 500,
        "observation_space": lambda: spaces.Box(-_CARTPOLE_HIGH, _CARTPOLE_HIGH, dtype=np.float32),
        "action_space": lambda: spaces.Discrete(2),
    },
    "Pendulum-v1": {
        "max_episode_steps": 200,
        "observation_space": lambda: spaces.Box(
            -np.array([1.0, 1.0, 8.0], np.float32), np.array([1.0, 1.0, 8.0], np.float32), dtype=np.float32
        ),
        "action_space": lambda: spaces.Box(-2.0, 2.0, (1,), np.float32),
    },
}


class ClassicControlEnv(Env):
    """One classic-control env over its torch twin (see the module
    docstring)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50}

    def __init__(self, id: str = "CartPole-v1", seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        if id not in CLASSIC_ENVS:
            raise ValueError(f"no host classic-control env for {id!r} (have {sorted(CLASSIC_ENVS)})")
        if render_mode not in (None, *self.metadata["render_modes"]):
            raise ValueError(f"render_mode must be one of {self.metadata['render_modes']} or None, got {render_mode!r}")
        self.render_mode = render_mode
        spec: JittableEnvSpec = get_jittable_env(id)
        self._spec = spec
        self.spec = EnvSpec(id)
        self.observation_space = CLASSIC_ENVS[id]["observation_space"]()
        self.action_space = CLASSIC_ENVS[id]["action_space"]()
        if seed is not None:
            self.action_space.seed(seed)
        self._generator = torch.Generator().manual_seed(0 if seed is None else int(seed))
        self._state: Optional[State] = None
        # Pendulum's last clipped torque, drawn as its arrow
        self.last_u: Optional[np.float32] = None

    def set_state(self, y: Any, t: int = 0, last_u: Optional[float] = None) -> np.ndarray:
        """Put the env in state ``y`` at step ``t`` (Pendulum: with the last
        torque ``last_u``); returns its observation."""
        self.last_u = None if last_u is None else np.float32(last_u)
        self._state = {
            "y": torch.as_tensor(np.array(y, np.float32)).reshape(1, -1),
            "t": torch.tensor([int(t)], dtype=torch.int32),
        }
        return self._spec.observation(self._state)[0].numpy()

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state = self._spec.init(self._generator, 1)
        self.last_u = None
        return self._spec.observation(self._state)[0].numpy(), {}

    def step(self, action: Any) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        act = torch.as_tensor(np.asarray(action).reshape(1, -1))
        if not self._spec.is_continuous:
            act = act.long()
        else:
            self.last_u = np.clip(np.asarray(action, np.float32).reshape(-1), -2.0, 2.0)[0]
        self._state, out = self._spec.step(self._state, act)
        # the step limit is TimeLimit's, as gymnasium's raw env has none
        return out.obs[0].numpy(), float(out.reward[0]), bool(out.terminated[0]), False, {}

    def render(self) -> Optional[np.ndarray]:
        """The ``rgb_array`` frame of the current state (``None`` without a
        render mode or before the first reset, as gymnasium)."""
        if self.render_mode is None or self._state is None:
            return None
        y = self._state["y"][0].double().tolist()
        if self.spec.id == "CartPole-v1":
            return _render.cartpole_frame(y[0], y[2])
        return _render.pendulum_frame(y[0], self.last_u)


def make_classic_env(id: str, seed: Optional[int] = None, render_mode: Optional[str] = None, **_: Any) -> Env:
    """``gymnasium.make(id, render_mode=...)`` for an id with a host env: the
    env behind ``TimeLimit`` at the registry's step limit."""
    return TimeLimit(ClassicControlEnv(id, seed=seed, render_mode=render_mode), CLASSIC_ENVS[id]["max_episode_steps"])
