"""The port's envs (sheeprl_tpu_torch/envs) against the JAX package's
(sheeprl_tpu/envs): the same seed and actions give the same frames,
rewards, terminations and truncations."""

import numpy as np
import pytest

from sheeprl_tpu.envs import dummy as jdummy
from sheeprl_tpu.envs.toy import PixelCatcher as JaxPixelCatcher
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.envs import dummy as tdummy
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.toy import PixelCatcher


def _rollout(env, actions, seed):
    obs, _ = env.reset(seed=seed)
    out = [(obs["rgb"].copy(), 0.0, False, False)]
    for a in actions:
        obs, r, term, trunc, info = env.step(a)
        out.append((obs["rgb"].copy(), r, term, trunc))
        if term or trunc:
            obs, _ = env.reset()
            out.append((obs["rgb"].copy(), 0.0, False, False))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("continuous", [False, True])
def test_pixel_catcher_matches_jax(seed, continuous):
    rng = np.random.default_rng(seed)
    n = 300
    actions = rng.uniform(-1, 1, (n, 1)).astype(np.float32) if continuous else rng.integers(0, 3, n)
    kw = dict(size=32, continuous_actions=continuous, seed=seed)
    got = _rollout(PixelCatcher(**kw), actions, seed)
    want = _rollout(JaxPixelCatcher(**kw), actions, seed)
    assert len(got) == len(want)
    assert any(w[2] for w in want)  # the run crossed at least one termination
    for (f1, r1, t1, u1), (f2, r2, t2, u2) in zip(got, want):
        np.testing.assert_array_equal(f1, f2)
        assert (r1, t1, u1) == (r2, t2, u2)


def test_pixel_catcher_spaces_match_jax():
    a, b = PixelCatcher(), JaxPixelCatcher()
    assert a.observation_space["rgb"].shape == b.observation_space["rgb"].shape == (64, 64, 3)
    assert a.observation_space["rgb"].dtype == b.observation_space["rgb"].dtype
    assert a.action_space.n == b.action_space.n
    assert spaces.action_dims(a.action_space) == ((3,), False)
    assert spaces.action_dims(PixelCatcher(continuous_actions=True).action_space) == ((1,), True)


@pytest.mark.parametrize("env_id", ["dummy_discrete", "dummy_multidiscrete", "dummy_continuous"])
def test_dummy_envs_match_jax(env_id):
    a, b = tdummy.get_dummy_env(env_id), jdummy.get_dummy_env(env_id)
    assert a.observation_space["state"].shape == b.observation_space["state"].shape
    for env in (a, b):
        env.reset(seed=0)
    for _ in range(6):
        act = np.zeros(2, np.float32) if "continuous" in env_id else (np.array([1, 0]) if "multi" in env_id else 1)
        o1, r1, t1, u1, _ = a.step(act)
        o2, r2, t2, u2, _ = b.step(act)
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(o1[k], o2[k])
        assert (r1, t1, u1) == (r2, t2, u2)


def test_make_env_caps_the_episode():
    cfg = compose("XS", overrides={"env.max_episode_steps": 3, "env.screen_size": 16})
    env = make_env(cfg, 0)()
    env.reset(seed=0)
    flags = [env.step(1)[3] for _ in range(3)]
    assert flags == [False, False, True]


def test_make_env_refuses_what_is_not_ported():
    # frame stacks are ported now (the JAX pipeline's FrameStack, NHWC frames on a leading axis)
    env = make_env(compose("XS", overrides={"env.frame_stack": 4, "env.screen_size": 16}), 0)()
    assert env.reset(seed=0)[0]["rgb"].shape == (4, 16, 16, 3)
    # gymnasium's registry (beyond the port's own classic-control envs,
    # whose frames it draws) and video capture are not
    with pytest.raises(NotImplementedError, match="gymnasium"):
        make_env(compose("XS", overrides={"env.wrapper": {"_target_": "gymnasium.make", "id": "LunarLander-v3"}}), 0)()
    with pytest.raises(NotImplementedError, match="capture_video"):
        make_env(compose("XS", overrides={"env.capture_video": True}), 0, 0, "run_dir")()


def test_multidiscrete_space_matches_the_jax_envs():
    """The multi-discrete dummy env's action space: the JAX package's sizes
    (``nvec``) as the port's ``action_dims``, samples of gymnasium's shape
    and dtype inside every sub-space, and ``contains``."""
    port, jax_env = tdummy.get_dummy_env("dummy_multidiscrete"), jdummy.get_dummy_env("dummy_multidiscrete")
    space = port.action_space
    assert spaces.action_dims(space) == (tuple(jax_env.action_space.nvec.tolist()), False)
    wide = spaces.MultiDiscrete([3, 5, 2], seed=0)
    draws = np.stack([wide.sample() for _ in range(500)])
    got, want = space.sample(), jax_env.action_space.sample()
    assert got.shape == want.shape == space.shape and got.dtype == want.dtype == draws.dtype
    assert (draws >= 0).all() and (draws < wide.nvec).all()
    assert all(len(np.unique(draws[:, i])) == n for i, n in enumerate(wide.nvec))
    assert wide.contains(np.array([2, 4, 1])) and not wide.contains(np.array([3, 0, 0]))
    assert space == spaces.MultiDiscrete([2, 2]) and space != wide
