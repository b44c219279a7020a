"""Env wrappers (port of ``sheeprl_tpu/envs/wrappers.py``) over a minimal
gymnasium-free ``Env``/``Wrapper`` base, with gymnasium's ``TimeLimit`` and
``RecordEpisodeStatistics``.

Images are NHWC uint8, as in the JAX package. A ``Wrapper`` forwards any
attribute it lacks to the env it wraps, and its ``observation_space`` and
``action_space`` are the wrapped env's until it sets its own.
``ImageTransform`` reproduces ``cv2.resize(..., INTER_AREA)`` and
``cv2.cvtColor(RGB2GRAY)`` in numpy (``resize_area``, ``rgb_to_gray``).
"""

from __future__ import annotations

import copy
import functools
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, SupportsFloat, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class EnvSpec(NamedTuple):
    """The part of gymnasium's ``EnvSpec`` the wrappers read."""

    id: str


class Env:
    """The env interface: ``reset``, ``step``, ``render``, ``close`` and the
    two spaces. ``spec`` is None unless the env was registered under an id."""

    metadata: Dict[str, Any] = {"render_modes": []}
    render_mode: Optional[str] = None
    spec: Optional[EnvSpec] = None
    observation_space: spaces.Space
    action_space: spaces.Space

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        raise NotImplementedError

    def step(self, action: Any):
        raise NotImplementedError

    def render(self) -> Any:
        return None

    def close(self) -> None:
        return None

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    """Wraps ``env``; whatever this class does not define is the env's."""

    def __init__(self, env: Any) -> None:
        self.env = env
        self._observation_space: Optional[spaces.Space] = None
        self._action_space: Optional[spaces.Space] = None

    def __getattr__(self, name: str) -> Any:
        if name == "env" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def observation_space(self) -> spaces.Space:
        return self._observation_space if self._observation_space is not None else self.env.observation_space

    @observation_space.setter
    def observation_space(self, space: spaces.Space) -> None:
        self._observation_space = space

    @property
    def action_space(self) -> spaces.Space:
        return self._action_space if self._action_space is not None else self.env.action_space

    @action_space.setter
    def action_space(self, space: spaces.Space) -> None:
        self._action_space = space

    @property
    def render_mode(self) -> Optional[str]:
        return getattr(self.env, "render_mode", None)

    @property
    def spec(self) -> Optional[EnvSpec]:
        return getattr(self.env, "spec", None)

    @property
    def unwrapped(self) -> Any:
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action: Any):
        return self.env.step(action)

    def render(self) -> Any:
        return self.env.render()

    def close(self) -> None:
        return self.env.close()


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps (gymnasium's
    ``TimeLimit``)."""

    def __init__(self, env: Any, max_episode_steps: int) -> None:
        super().__init__(env)
        if not (isinstance(max_episode_steps, int) and max_episode_steps > 0):
            raise ValueError(f"Expect the `max_episode_steps` to be positive, actually: {max_episode_steps}")
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps: Optional[int] = None

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed=None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)


class RecordEpisodeStatistics(Wrapper):
    """At an episode's end, ``info["episode"] = {"r": return, "l": length,
    "t": seconds}`` (gymnasium's ``RecordEpisodeStatistics``)."""

    def __init__(self, env: Any) -> None:
        super().__init__(env)
        self.episode_start_time: float = -1
        self.episode_returns: float = 0.0
        self.episode_lengths: int = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.episode_returns += reward
        self.episode_lengths += 1
        if terminated or truncated:
            if "episode" in info:
                raise RuntimeError("the env's info already holds an 'episode' key")
            seconds = round(time.perf_counter() - self.episode_start_time, 6)
            info["episode"] = {"r": self.episode_returns, "l": self.episode_lengths, "t": seconds}
            self.episode_start_time = time.perf_counter()
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = super().reset(seed=seed, options=options)
        self.episode_start_time = time.perf_counter()
        self.episode_returns = 0.0
        self.episode_lengths = 0
        return obs, info


class MaskVelocityWrapper(Wrapper):
    """Zero out velocity entries to make classic-control MDPs partially
    observable (JAX wrappers.py:19-45)."""

    velocity_indices: Dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
    }

    def __init__(self, env: Any):
        super().__init__(env)
        if getattr(env.unwrapped, "spec", None) is None:
            raise NotImplementedError("Velocity masking requires a registered env with a spec")
        env_id: str = env.unwrapped.spec.id
        self.mask = np.ones_like(env.observation_space.sample())
        try:
            self.mask[self.velocity_indices[env_id]] = 0.0
        except KeyError as e:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}") from e

    def observation(self, observation: np.ndarray) -> np.ndarray:
        return observation * self.mask

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self.observation(obs), reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info


class ActionRepeat(Wrapper):
    """Repeat each action up to ``amount`` times, summing rewards and cutting
    short on termination (JAX wrappers.py:48-71)."""

    def __init__(self, env: Any, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = amount

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        done = truncated = False
        total_reward = 0.0
        obs, info = None, {}
        for _ in range(self._amount):
            obs, reward, done, truncated, info = self.env.step(action)
            total_reward += reward
            if done or truncated:
                break
        return obs, total_reward, done, truncated, info


class RestartOnException(Wrapper):
    """Recreate a crashed environment, budgeted by a failure window (JAX
    wrappers.py:74-128). A restart surfaces
    ``info["restart_on_exception"] = True`` so the algorithm can patch its
    buffer. The pause before a restart is ``wait`` seconds through
    ``RestartOnException.sleep``."""

    sleep = staticmethod(time.sleep)

    def __init__(
        self,
        env_fn: Callable[..., Any],
        exceptions: Sequence[type] = (Exception,),
        window: float = 300,
        maxfails: int = 2,
        wait: float = 20,
    ):
        if not isinstance(exceptions, (tuple, list)):
            exceptions = (exceptions,)
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions)
        self._window = window
        self._maxfails = maxfails
        self._wait = wait
        self._last = time.time()
        self._fails = 0
        super().__init__(env_fn())

    def _register_failure(self, err: BaseException, phase: str) -> None:
        if time.time() > self._last + self._window:
            self._last = time.time()
            self._fails = 1
        else:
            self._fails += 1
        if self._fails > self._maxfails:
            raise RuntimeError(f"The env crashed too many times: {self._fails}") from err
        warnings.warn(f"{phase} - Restarting env after crash with {type(err).__name__}: {err}")
        type(self).sleep(self._wait)

    def step(self, action) -> Tuple[Any, SupportsFloat, bool, bool, Dict[str, Any]]:
        try:
            return self.env.step(action)
        except self._exceptions as e:
            self._register_failure(e, "STEP")
            self.env = self._env_fn()
            new_obs, info = self.env.reset()
            info["restart_on_exception"] = True
            return new_obs, 0.0, False, False, info

    def reset(self, *, seed=None, options=None) -> Tuple[Any, Dict[str, Any]]:
        try:
            return self.env.reset(seed=seed, options=options)
        except self._exceptions as e:
            self._register_failure(e, "RESET")
            self.env = self._env_fn()
            new_obs, info = self.env.reset(seed=seed, options=options)
            info["restart_on_exception"] = True
            return new_obs, info


class FrameStack(Wrapper):
    """Stack the last ``num_stack`` image frames (optionally dilated) for the
    given dict keys: ``[num_stack, H, W, C]``, NHWC frames on a leading
    axis (JAX wrappers.py:131-186)."""

    def __init__(self, env: Any, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1) -> None:
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack, expected a value greater than zero, got {num_stack}")
        if dilation <= 0:
            raise ValueError(f"The frame stack dilation argument must be greater than zero, got: {dilation}")
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(f"Expected an observation space of type gym.spaces.Dict, got: {type(env.observation_space)}")
        self._num_stack = num_stack
        self._dilation = dilation
        self._cnn_keys = [k for k, v in env.observation_space.spaces.items() if k in cnn_keys and len(v.shape) == 3]
        if not self._cnn_keys:
            raise RuntimeError("Specify at least one valid cnn key to be stacked")
        self.observation_space = copy.deepcopy(env.observation_space)
        for k in self._cnn_keys:
            space = env.observation_space[k]
            self.observation_space[k] = spaces.Box(
                np.repeat(space.low[None, ...], num_stack, axis=0),
                np.repeat(space.high[None, ...], num_stack, axis=0),
                (num_stack, *space.shape),
                space.dtype,
            )
        self._frames = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}

    def _get_obs(self, key: str) -> np.ndarray:
        frames = list(self._frames[key])[self._dilation - 1 :: self._dilation]
        assert len(frames) == self._num_stack
        return np.stack(frames, axis=0)

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
            obs[k] = self._get_obs(k)
        return obs, reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
            obs[k] = self._get_obs(k)
        return obs, info


class RewardAsObservationWrapper(Wrapper):
    """Expose the scalar reward as a ``reward`` observation key (JAX
    wrappers.py:189-217)."""

    def __init__(self, env: Any) -> None:
        super().__init__(env)
        reward_range = getattr(env, "reward_range", None) or (-np.inf, np.inf)
        reward_space = spaces.Box(*reward_range, (1,), np.float32)
        if isinstance(env.observation_space, spaces.Dict):
            self.observation_space = spaces.Dict({"reward": reward_space, **dict(env.observation_space.items())})
        else:
            self.observation_space = spaces.Dict({"obs": env.observation_space, "reward": reward_space})

    def _convert_obs(self, obs: Any, reward: Union[float, np.ndarray]) -> Dict[str, Any]:
        reward_obs = np.asarray(reward, dtype=np.float32).reshape(-1)
        if isinstance(obs, dict):
            obs["reward"] = reward_obs
            return obs
        return {"obs": obs, "reward": reward_obs}

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._convert_obs(obs, reward), reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._convert_obs(obs, 0.0), info


class GrayscaleRenderWrapper(Wrapper):
    """Expand grayscale render frames to 3 channels so video encoders accept
    them (JAX wrappers.py:220-231)."""

    def render(self) -> Optional[Union[np.ndarray, List[np.ndarray]]]:
        frame = super().render()
        if isinstance(frame, np.ndarray):
            if frame.ndim == 2:
                frame = frame[..., np.newaxis]
            if frame.ndim == 3 and frame.shape[-1] == 1:
                frame = frame.repeat(3, axis=-1)
        return frame


class DictObservation(Wrapper):
    """Wrap a non-dict observation space into a ``Dict`` under ``key`` (JAX
    wrappers.py:234-252)."""

    def __init__(self, env: Any, key: str) -> None:
        super().__init__(env)
        if isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError("observation space is already a Dict")
        self._key = key
        self.observation_space = spaces.Dict({key: env.observation_space})

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return {self._key: obs}, reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return {self._key: obs}, info


class RenderObservation(Wrapper):
    """Add a pixel observation rendered from the env under ``pixel_key``
    (JAX wrappers.py:255-303)."""

    def __init__(self, env: Any, pixel_key: str, pixels_only: bool = False, state_key: str = "state") -> None:
        super().__init__(env)
        if env.render_mode != "rgb_array":
            raise RuntimeError(f"RenderObservation requires render_mode='rgb_array', got {env.render_mode!r}")
        self._pixel_key = pixel_key
        self._pixels_only = pixels_only
        self._state_key = state_key
        frame = self._probe_frame(env)
        pixel_space = spaces.Box(0, 255, frame.shape, np.uint8)
        if pixels_only:
            self.observation_space = spaces.Dict({pixel_key: pixel_space})
        elif isinstance(env.observation_space, spaces.Dict):
            self.observation_space = spaces.Dict({pixel_key: pixel_space, **dict(env.observation_space.items())})
        else:
            self.observation_space = spaces.Dict({pixel_key: pixel_space, state_key: env.observation_space})

    @staticmethod
    def _probe_frame(env: Any) -> np.ndarray:
        env.reset()
        frame = env.render()
        if not isinstance(frame, np.ndarray):
            raise RuntimeError(f"render() must return an ndarray, got {type(frame)}")
        return frame

    def _convert(self, obs: Any) -> Dict[str, Any]:
        frame = np.asarray(self.env.render(), dtype=np.uint8)
        if self._pixels_only:
            return {self._pixel_key: frame}
        if isinstance(obs, dict):
            return {self._pixel_key: frame, **obs}
        return {self._pixel_key: frame, self._state_key: obs}

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._convert(obs), reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._convert(obs), info


# cv2's RGB2GRAY weights for 8-bit images: 0.299, 0.587, 0.114 in 15-bit
# fixed point, rounded by adding half before the shift (OpenCV 4 and 5's
# ``RGB2Gray<uchar>``; the 14-bit 4899/9617/1868 of older releases differs
# from it on about 0.3% of colours)
_GRAY_FIXED = (9798, 19235, 3735)
_GRAY_SHIFT = 15
_GRAY_FLOAT = (0.299, 0.587, 0.114)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for an ``[H, W, 3]`` image:
    bit for bit for uint8 (cv2's fixed point), the weighted sum otherwise."""
    if img.dtype == np.uint8:
        r, g, b = (img[..., i].astype(np.int32) for i in range(3))
        wr, wg, wb = _GRAY_FIXED
        return ((r * wr + g * wg + b * wb + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)
    x = img.astype(np.float32)
    wr, wg, wb = (np.float32(w) for w in _GRAY_FLOAT)
    return (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb).astype(img.dtype)


@functools.lru_cache(maxsize=None)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """``[dst, src]``: the share of source pixel ``j`` in output pixel ``i``
    of an area resample, each row summing to 1."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for i in range(dst):
        lo, hi = i * scale, min((i + 1) * scale, src)
        for j in range(int(np.floor(lo)), int(np.ceil(hi))):
            w[i, j] = min(hi, j + 1) - max(lo, j)
    return w / scale


# cv2's bilinear coefficients: 11 fractional bits (INTER_RESIZE_COEF_BITS)
_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def _linear_area_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """INTER_AREA's taps where it enlarges: for each output index the
    source index and its two 11-bit weights, from cv2's area-mode
    coefficients (``fx = (d + 1) - (s + 1) / scale``, fractional part, in
    float32), clamped at the last source pixel."""
    inv = dst / src
    scale = 1.0 / inv  # cv2 inverts the inverse scale
    d = np.arange(dst, dtype=np.float64)
    s = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (s + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    last = s >= src - 1
    s = np.where(last, src - 1, s)
    fx = np.where(last, np.float32(0), fx)
    w0 = np.rint((np.float32(1) - fx) * np.float32(_COEF_ONE)).astype(np.int64)
    w1 = np.rint(fx * np.float32(_COEF_ONE)).astype(np.int64)
    return s, w0, w1


def _resize_enlarge(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(..., INTER_AREA)`` of a uint8 image when an axis
    enlarges: cv2's bilinear path in 11-bit fixed point, the horizontal
    pass exact in int32, the vertical pass rounded as cv2's vector path
    does, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, then
    ``(+2) >> 2``, for every element of a row (cv2 5.0 rounds the rows'
    tails so too; held to it in ``tests/test_torch_classic_render.py``)."""
    h, w, c = img.shape
    sx, a0, a1 = _linear_area_taps(w, size)
    sy, b0, b1 = _linear_area_taps(h, size)
    src = img.astype(np.int64)
    sx1 = np.minimum(sx + 1, w - 1)
    rows = src[:, sx] * a0[None, :, None] + src[:, sx1] * a1[None, :, None]  # [h, size, c]
    s0 = rows[sy].reshape(size, size * c)
    s1 = rows[np.minimum(sy + 1, h - 1)].reshape(size, size * c)
    bb0, bb1 = b0[:, None], b1[:, None]
    out = ((((s0 >> 4) * bb0) >> 16) + (((s1 >> 4) * bb1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(size, size, c)


def resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)`` of an
    ``[H, W, C]`` image, channels kept. At an integer downscale it is cv2's
    block mean, bit for bit for uint8: a 2x2 block rounds half up (cv2's
    fast path), any other block rounds ``sum * (1 / area)`` in float32 to
    nearest even. At a fractional downscale it takes fractional area
    weights and rounds to nearest (within one grey level of cv2's float
    sums). Where an axis enlarges (a uint8 frame smaller than ``size``),
    cv2 interpolates bilinearly: :func:`_resize_enlarge`, bit for bit."""
    h, w, c = img.shape
    if size > h or size > w:
        if img.dtype != np.uint8:
            raise NotImplementedError(f"ImageTransform upscales a {img.dtype} image: the port enlarges uint8 frames only")
        return _resize_enlarge(img, size)
    is_int = np.issubdtype(img.dtype, np.integer)
    if h % size == 0 and w % size == 0:
        sy, sx = h // size, w // size
        sums = img.reshape(size, sy, size, sx, c).astype(np.int64 if is_int else np.float64).sum(axis=(1, 3))
        if not is_int:
            return (sums / (sy * sx)).astype(img.dtype)
        if sy == 2 and sx == 2 and c in (1, 3, 4):
            out = (sums + 2) >> 2
        else:
            out = np.rint(sums.astype(np.float32) * (np.float32(1) / np.float32(sy * sx)))
    else:
        # rows, then columns, each one BLAS product over contiguous operands
        wy, wx = _area_weights(h, size), _area_weights(w, size)
        rows = (wy @ img.reshape(h, w * c).astype(np.float64)).reshape(size, w, c)
        out = np.tensordot(wx, rows, axes=([1], [1])).transpose(1, 0, 2)
        if not is_int:
            return out.astype(img.dtype)
        out = np.rint(out)
    info = np.iinfo(img.dtype)
    return np.clip(out, info.min, info.max).astype(img.dtype)


class ImageTransform(Wrapper):
    """Resize / grayscale the image keys to ``[screen_size, screen_size, C]``
    NHWC uint8 (JAX wrappers.py:306-354), without cv2."""

    def __init__(self, env: Any, cnn_keys: Sequence[str], screen_size: int, grayscale: bool) -> None:
        super().__init__(env)
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError("ImageTransform requires a Dict observation space")
        self._cnn_keys = list(cnn_keys)
        self._screen_size = screen_size
        self._grayscale = grayscale
        self.observation_space = copy.deepcopy(env.observation_space)
        for k in self._cnn_keys:
            self.observation_space[k] = spaces.Box(0, 255, (screen_size, screen_size, 1 if grayscale else 3), np.uint8)

    def _transform(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., np.newaxis]
        # accept channel-first input from adapters and flip to NHWC
        if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        if img.shape[:2] != (self._screen_size, self._screen_size):
            img = resize_area(img, self._screen_size)
        if self._grayscale and img.shape[-1] == 3:
            img = rgb_to_gray(img)[..., np.newaxis]
        if not self._grayscale and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img.astype(np.uint8)

    def _convert(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        for k in self._cnn_keys:
            obs[k] = self._transform(obs[k])
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._convert(obs), reward, done, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._convert(obs), info
