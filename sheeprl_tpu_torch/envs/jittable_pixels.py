"""Pixel envs rendered from pure state: ``[B, H, W, 3]`` uint8 frames (port
of ``sheeprl_tpu/envs/jittable_pixels.py``).

The pixel counterpart of :mod:`sheeprl_tpu_torch.envs.jittable`: a
dependency-free benchmark env (no dm_control, no ALE) whose frame is a pure
function of the state vector, batched over a leading env axis.

- ``PixelPointmass-v0``: a damped point mass on the unit square pushed by a
  2-D force toward a fixed center target; per-step reward
  ``1 - tanh(8 * dist)``. Frames show the green target disc and the white
  agent disc.
- ``PixelPendulum-v0``: Pendulum-v1 dynamics (the vector twin's step) with
  the rod rendered from ``theta``; the classic negative angle cost.

Both specs register into :func:`~sheeprl_tpu_torch.envs.jittable
.get_jittable_env` at import. :class:`JittablePixelEnv` adapts a spec to
the host env API of ``envs/wrappers.py``: one env a instance, its state a
batch of one on the CPU (the JAX adapter runs its jitted programs on the
host backend too), frames under ``rgb``.

The masks compare a float32 squared distance with ``radius**2`` (``<=``);
XLA may contract those sums to FMAs where torch does not, so a pixel whose
distance lies within float32 rounding of the edge can differ from the JAX
frame (``tests/test_torch_jittable.py`` bounds it).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.jittable import (
    JittableEnvSpec,
    State,
    StepOut,
    _f32,
    _uniform,
    make_pendulum_spec,
    register_jittable_env,
)
from sheeprl_tpu_torch.envs.wrappers import Env

_PM_MAX_STEPS = 100
_PM_DAMPING = 0.8
_PM_FORCE = 0.02
_PM_TARGET = (0.5, 0.5)


def _pixel_centers(size: int, device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xx, yy)`` [size, size]: each pixel's center in unit coordinates,
    x right and y down (``jnp.meshgrid(..., indexing="xy")``)."""
    px = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    return torch.meshgrid(px, px, indexing="xy")


def _disc_mask(size: int, cx: torch.Tensor, cy: torch.Tensor, radius: float) -> torch.Tensor:
    """Boolean ``[B, size, size]`` discs at fractional centers ``(cx, cy)``
    [B] (unit coordinates, x right / y down)."""
    xx, yy = _pixel_centers(size, cx.device)
    return (xx - cx[:, None, None]) ** 2 + (yy - cy[:, None, None]) ** 2 <= _f32(radius**2)


def _paint(img: torch.Tensor, mask: torch.Tensor, color: Tuple[int, int, int]) -> torch.Tensor:
    rgb = torch.tensor(color, dtype=torch.uint8, device=img.device)
    return torch.where(mask[..., None], rgb, img)


def make_pixel_pointmass_spec(*, size: int = 64, env_id: str = "PixelPointmass-v0") -> JittableEnvSpec:
    """Damped point mass on the unit square, observed as rendered frames."""
    size = int(size)
    tx, ty = (_f32(v) for v in _PM_TARGET)

    def render(state: State) -> torch.Tensor:
        y = state["y"]
        img = torch.zeros((y.shape[0], size, size, 3), dtype=torch.uint8, device=y.device)
        target = torch.tensor([tx, ty], dtype=torch.float32, device=y.device).expand(y.shape[0], 2)
        img = _paint(img, _disc_mask(size, target[:, 0], target[:, 1], 4.0 / 64.0), (0, 200, 0))
        img = _paint(img, _disc_mask(size, y[:, 0], y[:, 1], 5.0 / 64.0), (255, 255, 255))
        return img

    def init(generator: torch.Generator, batch: int = 1) -> State:
        pos = _uniform(generator, (batch, 2), 0.1, 0.9)
        return {"y": torch.cat([pos, torch.zeros_like(pos)], -1), "t": torch.zeros(batch, dtype=torch.int32, device=pos.device)}

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        del generator
        y = state["y"]
        pos, vel = y[:, :2], y[:, 2:]
        action = torch.as_tensor(action, dtype=torch.float32, device=y.device)
        a = torch.clamp(action.reshape(y.shape[0], -1)[:, :2], -1.0, 1.0)
        vel = _PM_DAMPING * vel + _PM_FORCE * a
        new_pos = pos + vel
        clipped = torch.clamp(new_pos, 0.0, 1.0)
        # walls absorb: the velocity component that drove into the wall zeroes
        vel = torch.where(new_pos == clipped, vel, torch.zeros_like(vel))
        t = state["t"] + 1
        next_state = {"y": torch.cat([clipped, vel], -1).to(torch.float32), "t": t}
        target = torch.tensor([tx, ty], dtype=torch.float32, device=y.device)
        dist = torch.sqrt(torch.sum((clipped - target) ** 2, -1) + 1e-12)
        out = StepOut(
            obs=render(next_state),
            reward=(1.0 - torch.tanh(8.0 * dist)).to(torch.float32),
            terminated=torch.zeros_like(t, dtype=torch.bool),
            truncated=t >= _PM_MAX_STEPS,
        )
        return next_state, out

    return JittableEnvSpec(
        env_id=env_id,
        obs_dim=size * size * 3,
        is_continuous=True,
        action_dim=2,
        max_episode_steps=_PM_MAX_STEPS,
        init=init,
        step=step,
        observation=render,
        obs_shape=(size, size, 3),
    )


def make_pixel_pendulum_spec(*, size: int = 64, env_id: str = "PixelPendulum-v0") -> JittableEnvSpec:
    """Pendulum-v1 dynamics with the rod rendered from the state vector."""
    size = int(size)
    base = make_pendulum_spec()
    rod_len = 0.35  # unit coordinates; pivot at the frame center
    rod_halfwidth = 1.6 / 64.0

    def render(state: State) -> torch.Tensor:
        th = state["y"][:, 0]
        # theta 0 is upright; screen y grows downward
        tip_x, tip_y = 0.5 + rod_len * torch.sin(th), 0.5 - rod_len * torch.cos(th)
        xx, yy = _pixel_centers(size, th.device)
        # distance from each pixel to the pivot->tip segment
        dx, dy = (tip_x - 0.5)[:, None, None], (tip_y - 0.5)[:, None, None]
        seg2 = dx * dx + dy * dy + _f32(1e-12)
        tt = torch.clamp(((xx - 0.5) * dx + (yy - 0.5) * dy) / seg2, 0.0, 1.0)
        dist2 = (xx - (0.5 + tt * dx)) ** 2 + (yy - (0.5 + tt * dy)) ** 2
        img = torch.zeros((th.shape[0], size, size, 3), dtype=torch.uint8, device=th.device)
        img = _paint(img, dist2 <= _f32(rod_halfwidth**2), (230, 90, 90))
        center = torch.full_like(th, 0.5)
        img = _paint(img, _disc_mask(size, center, center, 2.5 / 64.0), (160, 160, 160))
        return img

    def step(state: State, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[State, StepOut]:
        next_state, out = base.step(state, action, generator)
        return next_state, out._replace(obs=render(next_state))

    return JittableEnvSpec(
        env_id=env_id,
        obs_dim=size * size * 3,
        is_continuous=True,
        action_dim=1,
        max_episode_steps=base.max_episode_steps,
        init=base.init,
        step=step,
        observation=render,
        obs_shape=(size, size, 3),
    )


_PIXEL_FACTORIES = {
    "PixelPointmass-v0": make_pixel_pointmass_spec,
    "PixelPendulum-v0": make_pixel_pendulum_spec,
}

for _factory in _PIXEL_FACTORIES.values():
    register_jittable_env(_factory())


@functools.lru_cache(maxsize=None)
def _compiled(env_id: str, size: int) -> JittableEnvSpec:
    """One spec per (id, size), shared by every host env instance."""
    factory = _PIXEL_FACTORIES.get(env_id)
    if factory is None:
        raise ValueError(f"unknown jittable pixel env '{env_id}' (have {sorted(_PIXEL_FACTORIES)})")
    return factory(size=size)


class JittablePixelEnv(Env):
    """Host adapter over a pixel spec: ``init``/``step``/``observation`` on
    a batch of one on the CPU, one env per instance, frames under the
    ``rgb`` key (the pixel pipeline's layout, like ``envs/toy.py``'s
    PixelCatcher). Episodes draw their initial state from a
    ``torch.Generator`` seeded by ``seed`` (0 when None) and reseeded by
    ``reset(seed=...)``."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}
    render_mode = "rgb_array"

    def __init__(self, id: str = "PixelPointmass-v0", size: int = 64, seed: Optional[int] = None) -> None:
        spec = self._spec = _compiled(str(id), int(size))
        self.observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, spec.obs_shape, np.uint8)})
        self.action_space = spaces.Box(-1.0, 1.0, (spec.action_dim,), np.float32)
        if seed is not None:
            self.action_space.seed(seed)
        self._generator = torch.Generator().manual_seed(0 if seed is None else int(seed))
        self._state: Optional[State] = None

    def set_state(self, y: Any, t: int = 0) -> Dict[str, np.ndarray]:
        """Put the env in state ``y`` at step ``t`` (as a JAX env's state is
        injected in the parity tests); returns its frame."""
        self._state = {
            "y": torch.as_tensor(np.array(y, np.float32)).reshape(1, -1),
            "t": torch.tensor([int(t)], dtype=torch.int32),
        }
        return self._frame()

    def _frame(self) -> Dict[str, np.ndarray]:
        return {"rgb": self._spec.observation(self._state)[0].numpy()}

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        if seed is not None:
            self._generator.manual_seed(int(seed))
            self.action_space.seed(seed)
        self._state = self._spec.init(self._generator, 1)
        return self._frame(), {}

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        act = torch.as_tensor(np.asarray(action, np.float32).reshape(1, -1))
        self._state, out = self._spec.step(self._state, act)
        return (
            {"rgb": out.obs[0].numpy()},
            float(out.reward[0]),
            bool(out.terminated[0]),
            bool(out.truncated[0]),
            {},
        )

    def render(self) -> np.ndarray:
        return self._frame()["rgb"]
