"""Host classic-control envs without gymnasium: ``CartPole-v1`` and
``Pendulum-v1`` over the torch twins of ``envs/jittable.py``, and
``Acrobot-v1``, ``MountainCar-v0`` and ``MountainCarContinuous-v0`` in numpy.

``ClassicControlEnv(id)`` is one env with the gym API: ``reset`` draws the
initial state from a ``torch.Generator`` seeded by ``reset(seed=...)``,
``step`` runs the twin's transition on a batch of one on the CPU. As
gymnasium's raw envs, it never truncates: ``make_classic_env`` wraps it in
``TimeLimit`` at the step limit gymnasium's registry sets (500 for
CartPole-v1, 200 for Pendulum-v1), as ``gymnasium.make`` does. The spaces
are gymnasium's. The dynamics are float32 where gymnasium's run in float64,
so a state agrees to float32 rounding; CartPole's rewards are exact and
Pendulum's agree to float32 rounding.

The three numpy envs (``HostClassicEnv``) have no JAX twin: each is
gymnasium 1.2.2's env written again, its arithmetic in the same order on
the same numpy types (Acrobot's ``book`` dynamics through gymnasium's RK4
in float64, the Mountain Cars' float64 and float32 updates), so a state,
a reward and a termination equal gymnasium's bit for bit. ``reset(seed)``
draws from ``np.random.Generator(PCG64(SeedSequence(seed)))``, the
generator gymnasium seeds, so the initial states equal gymnasium's too
(without a seed, seed 0 as ``ClassicControlEnv``).

``render()`` draws gymnasium's frames (600x400 for CartPole and the
Mountain Cars, 500x500 for Pendulum and Acrobot, ``rgb_array``) from the
env's state with the port's own numpy rasterizer (``envs/render.py``),
which holds them to gymnasium's pygame frames pixel for pixel; Pendulum
keeps the last clipped torque, ``last_u``, ``None`` after a reset, for its
arrow, as gymnasium does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import render as _render
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.jittable import JittableEnvSpec, State, get_jittable_env
from sheeprl_tpu_torch.envs.wrappers import Env, EnvSpec, TimeLimit

# gymnasium's registry: max_episode_steps, and the twins' observation and
# action spaces
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
    # the numpy envs below (``env``), each with its own spaces
    "Acrobot-v1": {"max_episode_steps": 500, "env": lambda *a, **k: AcrobotEnv(*a, **k)},
    "MountainCar-v0": {"max_episode_steps": 200, "env": lambda *a, **k: MountainCarEnv(*a, **k)},
    "MountainCarContinuous-v0": {"max_episode_steps": 999, "env": lambda *a, **k: ContinuousMountainCarEnv(*a, **k)},
}


class ClassicControlEnv(Env):
    """One classic-control env over its torch twin (see the module
    docstring)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50}

    def __init__(self, id: str = "CartPole-v1", seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        twins = sorted(k for k, v in CLASSIC_ENVS.items() if "env" not in v)
        if id not in twins:
            raise ValueError(f"no torch-twin classic-control env for {id!r} (have {twins}; make_classic_env builds every id)")
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


def _reset_bounds(options: Optional[Dict[str, Any]], low: float, high: float) -> Tuple[float, float]:
    """``gymnasium.envs.classic_control.utils.maybe_parse_reset_bounds``:
    ``options["low"]``/``["high"]`` over the defaults."""
    if options is None:
        return low, high
    low, high = float(options.get("low", low)), float(options.get("high", high))
    if low > high:
        raise ValueError(f"Lower bound ({low}) must be lower than higher bound ({high}).")
    return low, high


class HostClassicEnv(Env):
    """A classic-control env in numpy (see the module docstring): the
    generator gymnasium seeds, ``render_mode`` ``rgb_array`` or None, and
    no step limit of its own (``make_classic_env`` adds ``TimeLimit``)."""

    metadata: Dict[str, Any] = {"render_modes": ["rgb_array"]}

    def __init__(self, id: str, seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        if render_mode not in (None, *self.metadata["render_modes"]):
            raise ValueError(f"render_mode must be one of {self.metadata['render_modes']} or None, got {render_mode!r}")
        self.render_mode = render_mode
        self.spec = EnvSpec(id)
        if seed is not None:
            self.action_space.seed(seed)
        self._seed(0 if seed is None else seed)
        self.state: Any = None

    def _seed(self, seed: Optional[int]) -> None:
        if seed is not None:
            self.np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(int(seed))))


def _action_index(action: Any) -> int:
    """A discrete action of one element (a scalar or a one-element array)."""
    return int(np.asarray(action).reshape(()))


class AcrobotEnv(HostClassicEnv):
    """gymnasium's ``AcrobotEnv`` (``book`` dynamics, no torque noise)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 15}
    dt = 0.2
    LINK_LENGTH_1 = LINK_LENGTH_2 = 1.0
    LINK_MASS_1 = LINK_MASS_2 = 1.0
    LINK_COM_POS_1 = LINK_COM_POS_2 = 0.5
    LINK_MOI = 1.0
    MAX_VEL_1 = 4 * np.pi
    MAX_VEL_2 = 9 * np.pi
    AVAIL_TORQUE = [-1.0, 0.0, +1]

    def __init__(self, id: str = "Acrobot-v1", seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        high = np.array([1.0, 1.0, 1.0, 1.0, self.MAX_VEL_1, self.MAX_VEL_2], dtype=np.float32)
        self.observation_space = spaces.Box(-high, high, dtype=np.float32)
        self.action_space = spaces.Discrete(3)
        super().__init__(id, seed, render_mode)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        self._seed(seed)
        low, high = _reset_bounds(options, -0.1, 0.1)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,)).astype(np.float32)
        return self._get_ob(), {}

    def step(self, action: Any) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        torque = self.AVAIL_TORQUE[_action_index(action)]
        ns = _rk4(self._dsdt, np.append(self.state, torque), [0, self.dt])
        ns[0] = _wrap(ns[0], -np.pi, np.pi)
        ns[1] = _wrap(ns[1], -np.pi, np.pi)
        ns[2] = min(max(ns[2], -self.MAX_VEL_1), self.MAX_VEL_1)
        ns[3] = min(max(ns[3], -self.MAX_VEL_2), self.MAX_VEL_2)
        self.state = ns
        terminated = bool(-np.cos(ns[0]) - np.cos(ns[1] + ns[0]) > 1.0)
        return self._get_ob(), -1.0 if not terminated else 0.0, terminated, False, {}

    def _get_ob(self) -> np.ndarray:
        s = self.state
        return np.array([np.cos(s[0]), np.sin(s[0]), np.cos(s[1]), np.sin(s[1]), s[2], s[3]], dtype=np.float32)

    def _dsdt(self, s_augmented: np.ndarray) -> Tuple[float, ...]:
        m1, m2, l1 = self.LINK_MASS_1, self.LINK_MASS_2, self.LINK_LENGTH_1
        lc1, lc2, I1, I2 = self.LINK_COM_POS_1, self.LINK_COM_POS_2, self.LINK_MOI, self.LINK_MOI
        g = 9.8
        a = s_augmented[-1]
        theta1, theta2, dtheta1, dtheta2 = s_augmented[:-1]
        cos, sin, pi = np.cos, np.sin, np.pi
        d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * cos(theta2)) + I1 + I2
        d2 = m2 * (lc2**2 + l1 * lc2 * cos(theta2)) + I2
        phi2 = m2 * lc2 * g * cos(theta1 + theta2 - pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * cos(theta1 - pi / 2)
            + phi2
        )
        ddtheta2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * sin(theta2) - phi2) / (m2 * lc2**2 + I2 - d2**2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return dtheta1, dtheta2, ddtheta1, ddtheta2, 0.0

    def render(self) -> Optional[np.ndarray]:
        if self.render_mode is None or self.state is None:
            return None
        return _render.acrobot_frame(self.state)


def _wrap(x: float, m: float, M: float) -> float:
    """gymnasium's acrobot ``wrap``: ``x`` moved into ``[m, M]`` by whole turns."""
    diff = M - m
    while x > M:
        x = x - diff
    while x < m:
        x = x + diff
    return x


def _rk4(derivs: Any, y0: np.ndarray, t: Sequence[float]) -> np.ndarray:
    """gymnasium's acrobot ``rk4``: fourth-order Runge-Kutta in float64 over
    the sample times ``t``; the last state without the action."""
    yout = np.zeros((len(t), len(y0)), np.float64)
    yout[0] = y0
    for i in np.arange(len(t) - 1):
        this = t[i]
        dt = t[i + 1] - this
        dt2 = dt / 2.0
        y0 = yout[i]
        k1 = np.asarray(derivs(y0))
        k2 = np.asarray(derivs(y0 + dt2 * k1))
        k3 = np.asarray(derivs(y0 + dt2 * k2))
        k4 = np.asarray(derivs(y0 + dt * k3))
        yout[i + 1] = y0 + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return yout[-1][:4]


class MountainCarEnv(HostClassicEnv):
    """gymnasium's ``MountainCarEnv`` (``goal_velocity`` 0)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}
    min_position, max_position, max_speed = -1.2, 0.6, 0.07
    goal_position, goal_velocity = 0.5, 0
    force, gravity = 0.001, 0.0025

    def __init__(self, id: str = "MountainCar-v0", seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        low = np.array([self.min_position, -self.max_speed], dtype=np.float32)
        high = np.array([self.max_position, self.max_speed], dtype=np.float32)
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
        self.action_space = spaces.Discrete(3)
        super().__init__(id, seed, render_mode)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        self._seed(seed)
        low, high = _reset_bounds(options, -0.6, -0.4)
        self.state = np.array([self.np_random.uniform(low=low, high=high), 0])
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action: Any) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        action = _action_index(action)
        position, velocity = self.state
        velocity += (action - 1) * self.force + math.cos(3 * position) * (-self.gravity)
        velocity = np.clip(velocity, -self.max_speed, self.max_speed)
        position += velocity
        position = np.clip(position, self.min_position, self.max_position)
        if position == self.min_position and velocity < 0:
            velocity = 0
        terminated = bool(position >= self.goal_position and velocity >= self.goal_velocity)
        self.state = (position, velocity)
        return np.array(self.state, dtype=np.float32), -1.0, terminated, False, {}

    def render(self) -> Optional[np.ndarray]:
        if self.render_mode is None or self.state is None:
            return None
        return _render.mountain_car_frame(self.state[0], self.goal_position)


class ContinuousMountainCarEnv(MountainCarEnv):
    """gymnasium's ``Continuous_MountainCarEnv``: a force in [-1, 1], the
    state float32 after the first step, as gymnasium stores it."""

    min_action, max_action = -1.0, 1.0
    goal_position = 0.45
    power = 0.0015

    def __init__(self, id: str = "MountainCarContinuous-v0", seed: Optional[int] = None, render_mode: Optional[str] = None) -> None:
        super().__init__(id, seed, render_mode)
        self.action_space = spaces.Box(self.min_action, self.max_action, (1,), np.float32)
        if seed is not None:
            self.action_space.seed(seed)

    def step(self, action: Any) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        position = self.state[0]
        velocity = self.state[1]
        force = min(max(action[0], self.min_action), self.max_action)
        velocity += force * self.power - 0.0025 * math.cos(3 * position)
        if velocity > self.max_speed:
            velocity = self.max_speed
        if velocity < -self.max_speed:
            velocity = -self.max_speed
        position += velocity
        if position > self.max_position:
            position = self.max_position
        if position < self.min_position:
            position = self.min_position
        if position == self.min_position and velocity < 0:
            velocity = 0
        terminated = bool(position >= self.goal_position and velocity >= self.goal_velocity)
        reward = 0
        if terminated:
            reward = 100.0
        reward -= math.pow(action[0], 2) * 0.1
        self.state = np.array([position, velocity], dtype=np.float32)
        return self.state.copy(), reward, terminated, False, {}


def make_classic_env(id: str, seed: Optional[int] = None, render_mode: Optional[str] = None, **_: Any) -> Env:
    """``gymnasium.make(id, render_mode=...)`` for an id with a host env: the
    env behind ``TimeLimit`` at the registry's step limit."""
    entry = CLASSIC_ENVS[id]
    env = entry.get("env", ClassicControlEnv)(id, seed=seed, render_mode=render_mode)
    return TimeLimit(env, entry["max_episode_steps"])
