"""The port's Acrobot-v1, MountainCar-v0 and MountainCarContinuous-v0
(``envs/classic.py``, numpy) and their frames (``envs/render.py``) against
gymnasium's, and ``pygame.draw``'s ``line`` and ``aalines`` alone against
pygame. gymnasium and pygame are installed here; the port imports neither.

Bounds held, all exact (0):
- the spaces and the step limits of gymnasium's registry;
- free-running episodes from the same seeds (gymnasium's generator, so the
  same initial states), with the same actions: every observation, reward,
  termination and truncation bit-equal, and teacher-forced transitions from
  seeded states the same (the 1e-6 bound of CartPole's float32 twin was
  allowed; none was needed: the dynamics run gymnasium's arithmetic on the
  same numpy types, float64 RK4 for Acrobot);
- every frame at every pixel, at reset states (float32 for Acrobot) and
  along the episodes;
- ``line`` where both ends lie on the canvas and for horizontal and vertical
  lines crossing it (pygame moves a diagonal's off-canvas end onto the edge
  first; that is not copied, see ``render.line``), and ``aalines``, open and
  closed, partly off the canvas, over a coloured background;
- after the JAX pipeline (``make_env`` of ``exp=dreamer_v3`` with each id,
  64x64 with cv2): every channel's difference 0, free-running.
"""

import os

os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")

import gymnasium  # noqa: E402
import numpy as np  # noqa: E402
import pygame  # noqa: E402
import pytest  # noqa: E402

from sheeprl_tpu.config.compose import compose as jax_compose  # noqa: E402
from sheeprl_tpu.envs import factory as jfactory  # noqa: E402
from sheeprl_tpu_torch.config.compose import compose as port_compose  # noqa: E402
from sheeprl_tpu_torch.envs import factory as tfactory  # noqa: E402
from sheeprl_tpu_torch.envs import render as R  # noqa: E402
from sheeprl_tpu_torch.envs.classic import CLASSIC_ENVS, make_classic_env  # noqa: E402
from sheeprl_tpu_torch.utils.utils import dotdict  # noqa: E402

IDS = ["Acrobot-v1", "MountainCar-v0", "MountainCarContinuous-v0"]
EPISODE_STEPS = 210  # past MountainCar-v0's limit of 200: its truncation is compared
FRAME_EVERY = 30
CANVAS = (50, 70)


def _action(env_id, rng):
    if env_id == "MountainCarContinuous-v0":
        return rng.uniform(-1.5, 1.5, (1,)).astype(np.float32)  # out of range too: clipped
    return int(rng.integers(0, 3))


def _assert_step_equal(want, got, where):
    obs_w, rew_w, term_w, trunc_w, _ = want
    obs_g, rew_g, term_g, trunc_g, _ = got
    assert obs_g.dtype == obs_w.dtype == np.float32, where
    np.testing.assert_array_equal(obs_g, obs_w, err_msg=where)
    assert (rew_g, term_g, trunc_g) == (rew_w, term_w, trunc_w), where


@pytest.mark.parametrize("env_id", IDS)
def test_spaces_and_step_limits_are_gymnasiums(env_id):
    gym_env = gymnasium.make(env_id)
    port = make_classic_env(env_id, seed=0)
    assert CLASSIC_ENVS[env_id]["max_episode_steps"] == gym_env.spec.max_episode_steps
    for name in ("observation_space", "action_space"):
        want, got = getattr(gym_env, name), getattr(port, name)
        assert type(got).__name__ == type(want).__name__ and got.shape == want.shape and got.dtype == want.dtype
        if hasattr(want, "low"):
            np.testing.assert_array_equal(got.low, want.low)
            np.testing.assert_array_equal(got.high, want.high)
        else:
            assert got.n == want.n


@pytest.mark.parametrize("env_id", IDS)
def test_free_running_episodes_and_frames_equal_gymnasiums(env_id):
    gym_env = gymnasium.make(env_id, render_mode="rgb_array")
    port = make_classic_env(env_id, seed=0, render_mode="rgb_array")
    rng = np.random.default_rng(1)
    for episode in range(2):
        want, _ = gym_env.reset(seed=10 + episode)
        got, _ = port.reset(seed=10 + episode)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port.render(), gym_env.render(), err_msg=f"{env_id} reset frame")
        for t in range(EPISODE_STEPS):
            action = _action(env_id, rng)
            want_step, got_step = gym_env.step(action), port.step(action)
            _assert_step_equal(want_step, got_step, f"{env_id} episode {episode} step {t}")
            if t % FRAME_EVERY == 0:
                np.testing.assert_array_equal(port.render(), gym_env.render(), err_msg=f"{env_id} step {t}")
            if want_step[2] or want_step[3]:
                break


def _seeded_state(env_id, rng):
    if env_id == "Acrobot-v1":
        return np.concatenate([rng.uniform(-np.pi, np.pi, 2), rng.uniform(-12, 12, 1), rng.uniform(-28, 28, 1)])
    state = np.array([rng.uniform(-1.2, 0.6), rng.uniform(-0.07, 0.07)])
    return state.astype(np.float32) if env_id == "MountainCarContinuous-v0" else state


@pytest.mark.parametrize("env_id", IDS)
def test_teacher_forced_transitions_and_frames_equal_gymnasiums(env_id):
    gym_env = gymnasium.make(env_id, render_mode="rgb_array")
    port = make_classic_env(env_id, seed=0, render_mode="rgb_array")
    gym_env.reset(seed=0)
    port.reset(seed=0)
    rng = np.random.default_rng(2)
    for i in range(40):
        state = _seeded_state(env_id, rng)
        gym_env.unwrapped.state = state.copy()
        port.unwrapped.state = state.copy()
        if i % 4 == 0:
            np.testing.assert_array_equal(port.render(), gym_env.render(), err_msg=f"{env_id} state {state}")
        action = _action(env_id, rng)
        _assert_step_equal(gym_env.unwrapped.step(action), port.unwrapped.step(action), f"{env_id} state {state}")


def test_render_modes_follow_gymnasium():
    for env_id in IDS:
        env = make_classic_env(env_id)
        assert env.render() is None  # no render mode
        env = make_classic_env(env_id, render_mode="rgb_array")
        assert env.render() is None  # before the first reset, as gymnasium
        env.reset(seed=0)
        assert env.render().shape == ((500, 500, 3) if env_id == "Acrobot-v1" else (400, 600, 3))
        with pytest.raises(ValueError, match="render_mode"):
            make_classic_env(env_id, render_mode="human")
    with pytest.raises(ValueError, match="Lower bound"):
        make_classic_env("Acrobot-v1").reset(seed=0, options={"low": 0.2, "high": 0.1})


def _surface():
    surf = pygame.Surface(CANVAS[::-1])
    surf.fill((255, 255, 255))
    pygame.draw.line(surf, (10, 200, 90), (0, CANVAS[0] - 1), (CANVAS[1] - 1, 0), 7)
    return surf


def _pixels(surf):
    return np.transpose(np.array(pygame.surfarray.pixels3d(surf)), (1, 0, 2)).copy()


def test_line_equals_pygames():
    h, w = CANVAS
    rng = np.random.default_rng(3)
    for i in range(300):
        if i % 3:  # both ends on the canvas
            start, end = (rng.uniform(0, w), rng.uniform(0, h)), (rng.uniform(0, w), rng.uniform(0, h))
        else:  # horizontal or vertical, crossing the canvas or beside it
            at, a, b = rng.uniform(-3, max(h, w) + 3), *rng.uniform(-50, w + 50, 2)
            start, end = ((a, at), (b, at)) if i % 2 else ((at, a), (at, b))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        surf = _surface()
        got = _pixels(surf)
        pygame.draw.line(surf, color, start, end)
        R.line(got, start, end, color)
        np.testing.assert_array_equal(got, _pixels(surf), err_msg=f"{start} {end}")


def test_aalines_equal_pygames():
    h, w = CANVAS
    rng = np.random.default_rng(4)
    for i in range(200):
        points = [(rng.uniform(-15, w + 15), rng.uniform(-15, h + 15)) for _ in range(int(rng.integers(2, 8)))]
        closed = bool(i % 2)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        surf = _surface()
        got = _pixels(surf)
        pygame.draw.aalines(surf, color, closed, points)
        R.aalines(got, points, color, closed)
        np.testing.assert_array_equal(got, _pixels(surf), err_msg=f"{points} closed={closed}")


@pytest.mark.parametrize("env_id", IDS)
def test_the_pipeline_matches_the_jax_packages(env_id):
    """``make_env`` of ``exp=dreamer_v3`` with the id in both packages,
    free-running from one seed with the same actions: the 64x64 frames,
    rewards and ends equal."""
    overrides = ["exp=dreamer_v3", f"env.id={env_id}", "env.capture_video=False"]
    jcfg, tcfg = dotdict(jax_compose("config", overrides)), dotdict(port_compose("config", overrides))
    jenv, tenv = jfactory.make_env(jcfg, 3, 0, None, "train")(), tfactory.make_env(tcfg, 3, 0, None, "train")()
    jobs, _ = jenv.reset(seed=0)
    tobs, _ = tenv.reset(seed=0)
    assert tenv.observation_space["rgb"].shape == jenv.observation_space["rgb"].shape == (64, 64, 3)
    np.testing.assert_array_equal(tobs["rgb"], jobs["rgb"])
    rng = np.random.default_rng(5)
    for t in range(25):
        action = _action(env_id, rng)
        jout, tout = jenv.step(action), tenv.step(action)
        np.testing.assert_array_equal(tout[0]["rgb"], jout[0]["rgb"], err_msg=f"{env_id} step {t}")
        assert tout[1:4] == jout[1:4]
