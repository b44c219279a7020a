"""Pure-functional environments over torch tensors (port of
``sheeprl_tpu/envs/jittable.py``).

The JAX module writes classic-control dynamics as jax-pure functions of an
explicit state pytree, one env each, batched with ``jax.vmap``. Here the
same functions are pure torch over a leading env axis, so a batch of envs
steps in a handful of tensor ops on whatever device holds the state (the
host adapter of ``envs/jittable_pixels.py`` keeps them on the CPU; a later
rollout can replay them on the card inside a CUDA graph).

API (batched over ``B`` envs):

- ``spec.init(generator, batch) -> state``: fresh episodes,
  ``{"y": f32[B, state_dim], "t": i32[B]}``, drawn from an explicit
  ``torch.Generator`` (in place of the JAX threefry key) on the generator's
  device.
- ``spec.step(state, action, generator=None) -> (next_state, StepOut)``:
  one transition; ``StepOut.obs`` is the observation of ``next_state``
  before any autoreset (gymnasium's ``final_obs``).
- ``spec.observation(state) -> obs``: the observation of a state.

Every constant is applied in float32, as JAX applies a Python scalar to a
float32 array (``_f32``); ``_angle_normalize`` is floor-mod, as JAX's
``%`` is (``torch.remainder``, not ``torch.fmod``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

State = Dict[str, torch.Tensor]

Scalar = Any  # python float or a tensor broadcastable over the env axis


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX uses a Python constant against a
    float32 array."""
    return float(np.float32(x))


class StepOut(NamedTuple):
    """One batch of transitions, pre-autoreset (gymnasium step tuple)."""

    obs: torch.Tensor  # [B, *obs_shape] — observation of the raw next state
    reward: torch.Tensor  # f32[B]
    terminated: torch.Tensor  # bool[B]
    truncated: torch.Tensor  # bool[B]


class JittableEnvSpec(NamedTuple):
    """A pure-functional env: metadata + ``init``/``step``/``observation``."""

    env_id: str
    obs_dim: int
    is_continuous: bool
    # discrete: number of actions; continuous: action vector dimension
    action_dim: int
    max_episode_steps: int
    init: Callable[[torch.Generator, int], State]
    step: Callable[..., Tuple[State, StepOut]]
    observation: Callable[[State], torch.Tensor]
    # pixel envs (envs/jittable_pixels.py) carry the full frame shape here;
    # vector envs leave it None and expose ``(obs_dim,)`` implicitly
    obs_shape: Optional[Tuple[int, ...]] = None


def _uniform(generator: torch.Generator, shape: Tuple[int, ...], low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return low + (high - low) * u


# ---------------------------------------------------------------------------
# CartPole-v1 (gymnasium/envs/classic_control/cartpole.py)
# ---------------------------------------------------------------------------

_CP_GRAVITY = 9.8
_CP_MASSCART = 1.0
_CP_MASSPOLE = 0.1
_CP_LENGTH = 0.5  # half the pole's length
_CP_FORCE_MAG = 10.0
_CP_TAU = 0.02
_CP_THETA_THRESHOLD = _f32(12 * 2 * math.pi / 360)
_CP_X_THRESHOLD = _f32(2.4)
_CP_MAX_STEPS = 500


def _cartpole_init(generator: torch.Generator, batch: int = 1) -> State:
    y = _uniform(generator, (batch, 4), -0.05, 0.05)
    return {"y": y, "t": torch.zeros(batch, dtype=torch.int32, device=y.device)}


def _cartpole_obs(state: State) -> torch.Tensor:
    return state["y"]


def make_cartpole_spec(
    *,
    gravity: Scalar = _CP_GRAVITY,
    masscart: Scalar = _CP_MASSCART,
    masspole: Scalar = _CP_MASSPOLE,
    length: Scalar = _CP_LENGTH,
    force_mag: Scalar = _CP_FORCE_MAG,
    tau: Scalar = _CP_TAU,
) -> JittableEnvSpec:
    """CartPole-v1 twin with overridable physics (python floats or tensors)."""

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        del generator  # deterministic dynamics; the slot is for stochastic envs
        total_mass = masspole + masscart
        polemass_length = masspole * length
        x, x_dot, theta, theta_dot = state["y"].unbind(-1)
        action = torch.as_tensor(action, device=x.device).reshape(x.shape)
        f = torch.full_like(x, _f32(force_mag)) if not torch.is_tensor(force_mag) else force_mag.to(x)
        force = torch.where(action == 1, f, -f)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (length * (4.0 / 3.0 - masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        # Euler integration, gymnasium's kinematics_integrator="euler" order
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        y = torch.stack([x, x_dot, theta, theta_dot], -1).to(torch.float32)
        t = state["t"] + 1
        terminated = (x < -_CP_X_THRESHOLD) | (x > _CP_X_THRESHOLD) | (theta < -_CP_THETA_THRESHOLD) | (theta > _CP_THETA_THRESHOLD)
        truncated = t >= _CP_MAX_STEPS
        out = StepOut(obs=y, reward=torch.ones_like(x), terminated=terminated, truncated=truncated)
        return {"y": y, "t": t}, out

    return JittableEnvSpec(
        env_id="CartPole-v1",
        obs_dim=4,
        is_continuous=False,
        action_dim=2,
        max_episode_steps=_CP_MAX_STEPS,
        init=_cartpole_init,
        step=step,
        observation=_cartpole_obs,
    )


TorchCartPole = make_cartpole_spec()


# ---------------------------------------------------------------------------
# Pendulum-v1 (gymnasium/envs/classic_control/pendulum.py)
# ---------------------------------------------------------------------------

_PD_MAX_SPEED = 8.0
_PD_MAX_TORQUE = 2.0
_PD_DT = 0.05
_PD_G = 10.0
_PD_M = 1.0
_PD_L = 1.0
_PD_MAX_STEPS = 200
_PI32 = _f32(math.pi)
_TWO_PI32 = _f32(2 * math.pi)


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + _PI32, _TWO_PI32) - _PI32


def _pendulum_init(generator: torch.Generator, batch: int = 1) -> State:
    th = _uniform(generator, (batch,), -_PI32, _PI32)
    thdot = _uniform(generator, (batch,), -1.0, 1.0)
    return {"y": torch.stack([th, thdot], -1), "t": torch.zeros(batch, dtype=torch.int32, device=th.device)}


def _pendulum_obs(state: State) -> torch.Tensor:
    th, thdot = state["y"].unbind(-1)
    return torch.stack([torch.cos(th), torch.sin(th), thdot], -1).to(torch.float32)


def make_pendulum_spec(*, g: Scalar = _PD_G, m: Scalar = _PD_M, l: Scalar = _PD_L, dt: Scalar = _PD_DT) -> JittableEnvSpec:  # noqa: E741
    """Pendulum-v1 twin with overridable physics (python floats or tensors)."""

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        del generator
        th, thdot = state["y"].unbind(-1)
        action = torch.as_tensor(action, dtype=torch.float32, device=th.device)
        u = torch.clamp(action.reshape(th.shape[0], -1)[:, 0], -_PD_MAX_TORQUE, _PD_MAX_TORQUE)
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3 * g / (2 * l) * torch.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = torch.clamp(newthdot, -_PD_MAX_SPEED, _PD_MAX_SPEED)
        newth = th + newthdot * dt
        y = torch.stack([newth, newthdot], -1).to(torch.float32)
        t = state["t"] + 1
        next_state = {"y": y, "t": t}
        out = StepOut(
            obs=_pendulum_obs(next_state),
            reward=(-costs).to(torch.float32),
            terminated=torch.zeros_like(t, dtype=torch.bool),
            truncated=t >= _PD_MAX_STEPS,
        )
        return next_state, out

    return JittableEnvSpec(
        env_id="Pendulum-v1",
        obs_dim=3,
        is_continuous=True,
        action_dim=1,
        max_episode_steps=_PD_MAX_STEPS,
        init=_pendulum_init,
        step=step,
        observation=_pendulum_obs,
    )


TorchPendulum = make_pendulum_spec()


# Physics factories keyed by env id, for the ``physics_*`` scenario variants
# (``envs/variants.py``). Each maps the canonical
# randomization axes (size / speed / mass multipliers) onto the env's own
# constants.
def _cartpole_physics(size: Scalar, speed: Scalar, mass: Scalar) -> JittableEnvSpec:
    return make_cartpole_spec(length=_CP_LENGTH * size, tau=_CP_TAU * speed, masspole=_CP_MASSPOLE * mass)


def _pendulum_physics(size: Scalar, speed: Scalar, mass: Scalar) -> JittableEnvSpec:
    return make_pendulum_spec(l=_PD_L * size, dt=_PD_DT * speed, m=_PD_M * mass)


PHYSICS_FACTORIES: dict = {
    "CartPole-v1": _cartpole_physics,
    "Pendulum-v1": _pendulum_physics,
}


_REGISTRY = {
    "CartPole-v1": TorchCartPole,
    "Pendulum-v1": TorchPendulum,
}


def register_jittable_env(spec: JittableEnvSpec) -> None:
    """Register a twin under its ``env_id`` (idempotent overwrite)."""
    _REGISTRY[spec.env_id] = spec


def get_jittable_env(env_id: str) -> Optional[JittableEnvSpec]:
    """The pure twin of a gymnasium env id, or ``None`` when there is none."""
    if env_id not in _REGISTRY and (env_id.startswith("PixelPointmass") or env_id.startswith("PixelPendulum")):
        # lazy-register the pixel family so importing this module stays cheap
        from sheeprl_tpu_torch.envs import jittable_pixels  # noqa: F401
    return _REGISTRY.get(env_id)
