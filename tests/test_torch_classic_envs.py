"""The port's host ``CartPole-v1`` and ``Pendulum-v1`` (``envs/classic.py``)
against gymnasium's own envs, which are installed here.

Each step is teacher-forced: the port's env is put in gymnasium's state
(float64 there, float32 in the twin) and both take the same action. The
next observation within ``STEP_TOL``; CartPole's rewards, and every
``terminated`` and ``truncated``, exactly; Pendulum's reward, a float64 sum
in gymnasium and a float32 one in the twin, within ``STEP_TOL`` relative.
Both run behind their ``TimeLimit`` (500 and 200 steps, as gymnasium's
registry sets), and an episode ends on both at the same step.
"""

import gymnasium
import numpy as np
import pytest

from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.classic import CLASSIC_ENVS, ClassicControlEnv, make_classic_env
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.utils.utils import dotdict

STEP_TOL = 1e-6
STEPS = 200  # teacher-forced steps an episode of Pendulum


def _state(gym_env):
    return np.asarray(gym_env.unwrapped.state, np.float64)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_teacher_forced_steps_match_gymnasium(env_id):
    gym_env = gymnasium.make(env_id)
    port = make_classic_env(env_id, seed=0)
    assert port._max_episode_steps == gym_env.spec.max_episode_steps == CLASSIC_ENVS[env_id]["max_episode_steps"]
    np.testing.assert_array_equal(port.observation_space.low, gym_env.observation_space.low)
    np.testing.assert_array_equal(port.observation_space.high, gym_env.observation_space.high)
    assert port.observation_space.dtype == gym_env.observation_space.dtype
    rng = np.random.default_rng(0)
    gym_env.reset(seed=1)
    port.reset(seed=1)
    ends = 0
    for i in range(2 * STEPS + 20):
        y = _state(gym_env)
        port.env.set_state(y)
        if env_id == "CartPole-v1":
            action = int(rng.integers(0, 2))
        else:
            action = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)
        g_obs, g_rew, g_term, g_trunc, _ = gym_env.step(action)
        p_obs, p_rew, p_term, p_trunc, _ = port.step(action)
        np.testing.assert_allclose(p_obs, g_obs, atol=STEP_TOL, rtol=STEP_TOL)
        assert p_obs.dtype == np.float32
        if env_id == "CartPole-v1":
            assert p_rew == g_rew
        else:
            np.testing.assert_allclose(p_rew, g_rew, rtol=STEP_TOL, atol=STEP_TOL)
        assert (p_term, p_trunc) == (g_term, g_trunc), i
        if env_id == "CartPole-v1" and i == 100:
            # the step limit: both one step short of it
            port._elapsed_steps = gym_env._elapsed_steps = 499
        if g_term or g_trunc:
            ends += 1
            gym_env.reset(seed=10 + i)
            port.reset(seed=10 + i)
    assert ends >= 2


def test_reset_is_seeded_and_in_gymnasiums_range():
    a, b = ClassicControlEnv("CartPole-v1"), ClassicControlEnv("CartPole-v1")
    obs_a, _ = a.reset(seed=4)
    obs_b, _ = b.reset(seed=4)
    np.testing.assert_array_equal(obs_a, obs_b)
    assert np.all(np.abs(obs_a) <= 0.05)
    p = ClassicControlEnv("Pendulum-v1")
    obs, _ = p.reset(seed=0)
    assert np.isclose(obs[0] ** 2 + obs[1] ** 2, 1.0, atol=1e-6) and abs(obs[2]) <= 1.0


def test_make_env_builds_the_host_env_for_gymnasium_make():
    cfg = dotdict(compose("config", ["exp=ppo", "env.capture_video=False"]))
    env = make_env(cfg, 0, 0, None, "train")()
    assert list(env.observation_space.keys()) == ["state"] and env.action_space.n == 2
    obs, _ = env.reset(seed=0)
    assert obs["state"].shape == (4,)
    env.close()


@pytest.mark.parametrize(
    "overrides",
    [["env.id=Acrobot-v1"], ["algo.cnn_keys.encoder=[rgb]"]],
)
def test_other_ids_and_pixels_raise_naming_a1(overrides):
    cfg = dotdict(compose("config", ["exp=ppo", "env.capture_video=False", *overrides]))
    with pytest.raises(NotImplementedError, match="A1"):
        make_env(cfg, 0, 0, None, "train")()
    with pytest.raises(NotImplementedError, match="A1"):
        ClassicControlEnv("CartPole-v1").render()
