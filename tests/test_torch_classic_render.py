"""The port's classic-control frames (``envs/render.py``, ``envs/classic.py``)
against gymnasium's, which pygame draws, and ``resize_area``'s enlargement
against cv2. Both are installed here; the port imports neither.

Bounds held:
- each primitive (``aapolygon``, ``filled_polygon``, ``aacircle``,
  ``filled_circle``, ``smoothscale`` of Pendulum's arrow) equals pygame's
  ``gfxdraw`` and ``transform`` pixel for pixel, anti-aliased edges
  included;
- full frames, CartPole-v1 (600x400) at seeded ``x, theta`` across the
  track, past its edges and past the termination angle, and Pendulum-v1
  (500x500) at seeded ``theta`` over the circle with ``last_u`` in
  ``{None, +-0.05, +-1.3, +-2}`` and drawn at random, equal gymnasium's
  ``render()`` at every pixel (a looser bound, exact only a pixel away
  from a drawn edge, was allowed; none was needed);
- after the JAX pipeline (``make_env`` of ``exp=dreamer_v3`` and
  ``exp=sac_ae``: ``RenderObservation``, ``ImageTransform`` to 64x64 with
  cv2, Pendulum's frame stack of 3), teacher-forced from the same seeded
  states: the maximum and the mean absolute difference of each channel,
  ``PIPELINE_MAX`` and ``PIPELINE_MEAN``, both 0;
- ``resize_area`` where an axis enlarges equals ``cv2.resize(...,
  INTER_AREA)`` bit for bit.

The same state goes into both envs through the port's ``set_state`` and
gymnasium's ``env.unwrapped.state``: their dynamics are float32 and
float64, and their generators draw different initial states, so free
trajectories are not compared.
"""

import os

os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")

import cv2  # noqa: E402
import gymnasium  # noqa: E402
import numpy as np  # noqa: E402
import pygame  # noqa: E402
import pytest  # noqa: E402
from pygame import gfxdraw  # noqa: E402

from sheeprl_tpu.config.compose import compose as jax_compose  # noqa: E402
from sheeprl_tpu.envs import factory as jfactory  # noqa: E402
from sheeprl_tpu_torch.config.compose import compose as port_compose  # noqa: E402
from sheeprl_tpu_torch.envs import render as R  # noqa: E402
from sheeprl_tpu_torch.envs import factory as tfactory  # noqa: E402
from sheeprl_tpu_torch.envs.classic import ClassicControlEnv, make_classic_env  # noqa: E402
from sheeprl_tpu_torch.envs.wrappers import resize_area  # noqa: E402
from sheeprl_tpu_torch.utils.utils import dotdict  # noqa: E402

STATES = 60  # seeded states of each env
PIPELINE_STEPS = 50
PIPELINE_MAX = 0  # max |port - JAX| of a 64x64 channel after the pipeline
PIPELINE_MEAN = 0.0
CANVAS = (50, 70)  # H, W of the primitive tests' surfaces
TORQUES = (None, 0.05, -0.05, 1.3, -1.3, 2.0, -2.0, "random")


def _surface(bg=(255, 255, 255)):
    surf = pygame.Surface(CANVAS[::-1])
    surf.fill(bg)
    return surf


def _pixels(surf):
    return np.transpose(np.array(pygame.surfarray.pixels3d(surf)), (1, 0, 2)).copy()


def _canvas(bg=(255, 255, 255)):
    return np.full((*CANVAS, 3), bg, np.uint8)


def _quads(seed, n):
    """Quads across the canvas, half of them partly off it (clipped)."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    for i in range(n):
        pad = 20 if i % 2 else -5
        xs, ys = rng.uniform(-pad, w + pad, 4), rng.uniform(-pad, h + pad, 4)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        yield [(float(x), float(y)) for x, y in zip(xs, ys)], color


@pytest.mark.parametrize("primitive", ["aapolygon", "filled_polygon"])
def test_polygons_equal_gfxdraw(primitive):
    for points, color in _quads(3, 150):
        bg = (255, 255, 255) if color[0] % 2 else (30, 90, 200)
        surf = _surface(bg)
        getattr(gfxdraw, primitive)(surf, points, color)
        img = _canvas(bg)
        getattr(R, primitive)(img, points, color)
        np.testing.assert_array_equal(img, _pixels(surf), err_msg=f"{primitive} {points} {color}")


def test_a_diagonal_edge_equals_gfxdraw():
    """An edge with |dx| == |dy| wraps Wu's 32-bit adjustment to 0, and the
    minor axis steps every pixel."""
    points = [(13.0, 37.0), (29.0, 21.0), (45.0, 21.0)]
    surf = _surface()
    gfxdraw.aapolygon(surf, points, (0, 0, 0))
    img = _canvas()
    R.aapolygon(img, points, (0, 0, 0))
    np.testing.assert_array_equal(img, _pixels(surf))


@pytest.mark.parametrize("primitive", ["aacircle", "filled_circle"])
def test_circles_equal_gfxdraw(primitive):
    rng = np.random.default_rng(5)
    h, w = CANVAS
    for rad in range(1, 31):
        x, y = int(rng.integers(-5, w + 5)), int(rng.integers(-5, h + 5))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        surf = _surface()
        getattr(gfxdraw, primitive)(surf, x, y, rad, color)
        img = _canvas()
        getattr(R, primitive)(img, x, y, rad, color)
        np.testing.assert_array_equal(img, _pixels(surf), err_msg=f"{primitive} r={rad} at {x},{y}")


def test_the_arrow_asset_is_gymnasiums():
    png = os.path.join(os.path.dirname(gymnasium.__file__), "envs", "classic_control", "assets", "clockwise.png")
    img = pygame.image.load(png)
    rgb = np.transpose(np.array(pygame.surfarray.pixels3d(img)), (1, 0, 2))
    alpha = np.transpose(np.array(pygame.surfarray.pixels_alpha(img)), (1, 0))
    np.testing.assert_array_equal(R._arrow(), np.concatenate([rgb, alpha[..., None]], -1))


def test_smoothscale_equals_pygames():
    """Every size Pendulum's arrow takes (0 to 113 pixels a side)."""
    png = os.path.join(os.path.dirname(gymnasium.__file__), "envs", "classic_control", "assets", "clockwise.png")
    img = pygame.image.load(png)
    for size in range(0, 114):
        scaled = pygame.transform.smoothscale(img, (size, size))
        want = np.concatenate(
            [
                np.transpose(np.array(pygame.surfarray.pixels3d(scaled)), (1, 0, 2)),
                np.transpose(np.array(pygame.surfarray.pixels_alpha(scaled)), (1, 0))[..., None],
            ],
            -1,
        ).reshape(size, size, 4)
        np.testing.assert_array_equal(R.smoothscale(R._arrow(), size, size), want, err_msg=f"size {size}")


def _cartpole_states(seed):
    rng = np.random.default_rng(seed)
    for i in range(STATES):
        # across the track, past its edges (the cart half off the frame) and
        # past the termination angle of 12 degrees
        x = rng.uniform(-2.7, 2.7) if i % 3 else rng.uniform(-2.4, 2.4)
        theta = rng.uniform(-1.5, 1.5) if i % 2 else rng.uniform(-0.21, 0.21)
        yield np.float32(x), np.float32(theta)


def _pendulum_states(seed):
    rng = np.random.default_rng(seed)
    for i in range(STATES):
        u = TORQUES[i % len(TORQUES)]
        u = np.float32(rng.uniform(-2, 2)) if u == "random" else (None if u is None else np.float32(u))
        yield np.float32(rng.uniform(-np.pi, np.pi)), u


def test_cartpole_frames_equal_gymnasiums():
    gym_env = gymnasium.make("CartPole-v1", render_mode="rgb_array")
    gym_env.reset(seed=0)
    port = ClassicControlEnv("CartPole-v1", render_mode="rgb_array")
    port.reset(seed=0)
    for x, theta in _cartpole_states(7):
        gym_env.unwrapped.state = np.array([x, 0.0, theta, 0.0], np.float64)
        port.set_state([x, 0.0, theta, 0.0])
        want = gym_env.render()
        got = port.render()
        assert got.shape == want.shape == (400, 600, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"x={x} theta={theta}")


def test_pendulum_frames_equal_gymnasiums():
    gym_env = gymnasium.make("Pendulum-v1", render_mode="rgb_array")
    gym_env.reset(seed=0)
    port = ClassicControlEnv("Pendulum-v1", render_mode="rgb_array")
    port.reset(seed=0)
    for theta, u in _pendulum_states(9):
        gym_env.unwrapped.state = np.array([theta, 0.0], np.float64)
        gym_env.unwrapped.last_u = u
        port.set_state([theta, 0.0], last_u=u)
        want = gym_env.render()
        got = port.render()
        assert got.shape == want.shape == (500, 500, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"theta={theta} last_u={u}")


def test_pendulum_keeps_the_last_torque_as_gymnasium():
    gym_env = gymnasium.make("Pendulum-v1", render_mode="rgb_array")
    port = make_classic_env("Pendulum-v1", seed=0, render_mode="rgb_array")
    gym_env.reset(seed=0)
    port.reset(seed=0)
    assert gym_env.unwrapped.last_u is None and port.unwrapped.last_u is None
    for action in (np.array([3.5], np.float32), np.array([-0.7], np.float32)):
        gym_env.step(action)
        port.step(action)
        assert port.unwrapped.last_u == gym_env.unwrapped.last_u
        assert type(port.unwrapped.last_u) is type(gym_env.unwrapped.last_u)
    port.reset(seed=1)
    assert port.unwrapped.last_u is None


def test_render_modes_follow_gymnasium():
    for env_id in ("CartPole-v1", "Pendulum-v1"):
        assert ClassicControlEnv(env_id).metadata["render_modes"] == ["rgb_array"]
        assert ClassicControlEnv(env_id).render() is None  # no render mode
        env = ClassicControlEnv(env_id, render_mode="rgb_array")
        assert env.render() is None  # before the first reset, as gymnasium
        env.reset(seed=0)
        assert env.render().dtype == np.uint8
        with pytest.raises(ValueError, match="render_mode"):
            ClassicControlEnv(env_id, render_mode="human")


def _pipeline_pair(exp):
    overrides = [f"exp={exp}", "env.capture_video=False"]
    jcfg, tcfg = dotdict(jax_compose("config", overrides)), dotdict(port_compose("config", overrides))
    return jfactory.make_env(jcfg, 3, 0, None, "train")(), tfactory.make_env(tcfg, 3, 0, None, "train")()


@pytest.mark.parametrize("exp", ["dreamer_v3", "sac_ae"])
def test_the_pipeline_matches_the_jax_packages(exp):
    """``make_env`` of the exp as composed in both packages, teacher-forced
    from the same seeded states: the 64x64 frames (a frame stack of 3 for
    SAC-AE) within ``PIPELINE_MAX`` and ``PIPELINE_MEAN`` a channel."""
    jenv, tenv = _pipeline_pair(exp)
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    assert tenv.observation_space["rgb"].shape == jenv.observation_space["rgb"].shape
    rng = np.random.default_rng(11)
    cartpole = exp == "dreamer_v3"
    # the reset frames (different initial states) leave the stack after it
    stack = 1 if cartpole else tenv.observation_space["rgb"].shape[0]
    diffs = []
    for i in range(PIPELINE_STEPS):
        if cartpole:
            y = np.array([rng.uniform(-2.3, 2.3), rng.uniform(-1, 1), rng.uniform(-0.15, 0.15), rng.uniform(-0.5, 0.5)], np.float32)
            action = int(rng.integers(0, 2))
        else:
            y = np.array([rng.uniform(-np.pi, np.pi), rng.uniform(-8, 8)], np.float32)
            action = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)
        jenv.unwrapped.state = y.astype(np.float64)
        tenv.unwrapped.set_state(y)
        jobs, _, jterm, jtrunc, _ = jenv.step(action)
        tobs, _, tterm, ttrunc, _ = tenv.step(action)
        assert tobs["rgb"].shape == jobs["rgb"].shape and tobs["rgb"].dtype == np.uint8
        assert (tterm, ttrunc) == (jterm, jtrunc)
        if i >= stack - 1:
            diffs.append(np.abs(tobs["rgb"].astype(np.int16) - jobs["rgb"].astype(np.int16)))
        assert not (jterm or jtrunc)  # CartPole's states stay inside its bounds
    diffs = np.stack(diffs).reshape(-1, 3)
    assert diffs.max(axis=0).tolist() == [PIPELINE_MAX] * 3
    assert diffs.mean(axis=0).tolist() == [PIPELINE_MEAN] * 3


@pytest.mark.parametrize(
    "shape, size",
    [
        ((32, 32, 3), 64),
        ((32, 32, 3), 84),
        ((40, 50, 3), 65),  # cv2 inverts the inverse scale: column 39 reads source 30
        ((50, 40, 1), 64),
        ((21, 37, 3), 64),
        ((64, 10, 3), 64),  # one axis kept, one enlarged
        ((100, 10, 3), 64),  # one axis shrunk, one enlarged
        ((1, 1, 3), 64),
        ((3, 3, 1), 7),  # rows narrower than a vector
        ((48, 48, 4), 100),
    ],
)
def test_resize_area_enlarges_as_cv2(shape, size):
    rng = np.random.default_rng(sum(shape) + size)
    for _ in range(5):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA).reshape(size, size, shape[2])
        np.testing.assert_array_equal(resize_area(img, size), want)


def test_resize_area_shrinks_rendered_frames_as_cv2():
    """The two frames' own downscales, 400x600 and 500x500 to 64."""
    for frame in (R.cartpole_frame(0.7, 0.1), R.cartpole_frame(-2.5, 1.2), R.pendulum_frame(1.0, 1.3), R.pendulum_frame(-2.0, None)):
        want = cv2.resize(frame, (64, 64), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(frame, 64), want)
