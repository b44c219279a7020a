"""The port's env pipeline (sheeprl_tpu_torch/envs/{spaces,wrappers,factory,
vector}.py) against the JAX package's (sheeprl_tpu/envs, over gymnasium and
cv2), on the same base envs, seeds and seeded actions.

Bounds: wrapper, ``make_env`` and vector-env outputs equal (observations,
flags, episode statistics; float rewards and reward observations within
1e-6, absolute and relative); ``ImageTransform`` bit-equal to cv2 at
integer factors and for grayscale, within 1 grey level at a fractional
factor; pixel envs start from states injected into both packages (their
noise streams differ), and their frames are equal but for mask-edge pixels
(``tests/test_torch_jittable.py``'s bound). Space draws are held by range,
dtype and frequency.
"""

import contextlib
import functools
import signal

import cv2
import gymnasium as gym
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.envs import factory as jfactory
from sheeprl_tpu.envs import wrappers as jw
from sheeprl_tpu_torch.config.compose import compose as port_compose
from sheeprl_tpu_torch.envs import factory as tfactory
from sheeprl_tpu_torch.envs import spaces as ts
from sheeprl_tpu_torch.envs import vector as tvector
from sheeprl_tpu_torch.envs import wrappers as tw
from sheeprl_tpu_torch.utils.utils import dotdict

# ---------------------------------------------------------------- base envs
# each base env is written once over a package's (Env, spaces) pair


def _counting(Env, S, n_steps=10):
    class Counting(Env):
        """1-D env whose obs is the step count and reward is 1 per step."""

        def __init__(self):
            self.observation_space = S.Box(-np.inf, np.inf, (1,), np.float32)
            self.action_space = S.Discrete(2)
            self._t = 0

        def step(self, action):
            self._t += 1
            return np.array([self._t], np.float32), 1.0, self._t >= n_steps, False, {}

        def reset(self, seed=None, options=None):
            self._t = 0
            return np.array([0.0], np.float32), {}

    return Counting()


def _flaky(Env, S, fails_left):
    class Flaky(Env):
        """Fails the step() calls while ``fails_left[0]`` (shared by the env
        and the envs that replace it) is positive; obs counts the steps."""

        def __init__(self):
            self.observation_space = S.Box(-1, 1, (1,), np.float32)
            self.action_space = S.Discrete(2)
            self._t = 0

        def step(self, action):
            if fails_left[0] > 0:
                fails_left[0] -= 1
                raise RuntimeError("env crash")
            self._t += 1
            return np.full(1, self._t, np.float32), 0.0, self._t >= 6, False, {}

        def reset(self, seed=None, options=None):
            return np.zeros(1, np.float32), {}

    return Flaky()


def _pixel(Env, S, size=8, channels=3, n_steps=12, vector=4):
    class Pixel(Env):
        """Dict obs: an ``rgb`` frame and a ``state`` vector, both encoding
        the step count; renders a grayscale frame; ends at ``n_steps``."""

        metadata = {"render_modes": ["rgb_array"]}
        render_mode = "rgb_array"

        def __init__(self):
            self.observation_space = S.Dict(
                {
                    "rgb": S.Box(0, 255, (size, size, channels), np.uint8),
                    "state": S.Box(-np.inf, np.inf, (vector,), np.float32),
                }
            )
            self.action_space = S.Box(-1, 1, (2,), np.float32)
            self._t = 0

        def _obs(self):
            rgb = (np.arange(size * size * channels).reshape(size, size, channels) * 7 + 13 * self._t) % 256
            return {"rgb": rgb.astype(np.uint8), "state": np.full((vector,), self._t, np.float32)}

        def step(self, action):
            self._t += 1
            return self._obs(), float(np.sum(action)) + 0.5, self._t >= n_steps, False, {}

        def reset(self, seed=None, options=None):
            self._t = 0
            return self._obs(), {}

        def render(self):
            return self._obs()["rgb"][..., 0]

    return Pixel()


JAX = (gym.Env, gym.spaces)
PORT = (tw.Env, ts)


def _same(a, b):
    """Two observations (or infos) equal, dicts key by key; floats within
    1e-6 (absolute, and relative above 1: the reward observation of an env
    whose reward is a float32 sum)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif np.asarray(b).dtype.kind == "f":
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=1e-6)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_space(t, j):
    if isinstance(j, gym.spaces.Dict):
        assert isinstance(t, ts.Dict) and list(t.keys()) == list(j.keys())
        for k in j.keys():
            _same_space(t[k], j[k])
    elif isinstance(j, gym.spaces.Discrete):
        assert isinstance(t, ts.Discrete) and t.n == j.n
    else:
        assert isinstance(t, ts.Box) and t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_array_equal(t.low, j.low)
        np.testing.assert_array_equal(t.high, j.high)


def _roll(env, actions, seed=0):
    obs, _ = env.reset(seed=seed)
    out = [obs]
    for a in actions:
        obs, r, term, trunc, info = env.step(a)
        out.append((obs, r, term, trunc, {k: v for k, v in info.items() if k != "episode"}))
        if term or trunc:
            out.append(env.reset()[0])
    return out


def _hold(jenv, tenv, actions):
    _same_space(tenv.observation_space, jenv.observation_space)
    _same_space(tenv.action_space, jenv.action_space)
    got, want = _roll(tenv, actions), _roll(jenv, actions)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w) if isinstance(w, dict) else [_same(x, y) for x, y in zip(g, w)]


# ------------------------------------------------------------------ wrappers

WRAPPERS = {
    "action_repeat": lambda W, E, S: W.ActionRepeat(_counting(E, S), 3),
    "action_repeat_stops": lambda W, E, S: W.ActionRepeat(_counting(E, S, n_steps=4), 3),
    "mask_velocity": lambda W, E, S: W.MaskVelocityWrapper(_mask_base(E, S)),
    "restart_on_exception": lambda W, E, S: _restarting(W, E, S),
    "frame_stack_dilated": lambda W, E, S: W.FrameStack(_pixel(E, S), 3, ["rgb"], dilation=2),
    "reward_as_observation": lambda W, E, S: W.RewardAsObservationWrapper(_pixel(E, S)),
    "reward_as_observation_box": lambda W, E, S: W.RewardAsObservationWrapper(_counting(E, S)),
    "grayscale_render": lambda W, E, S: W.GrayscaleRenderWrapper(_pixel(E, S)),
    "dict_observation": lambda W, E, S: W.DictObservation(_counting(E, S), "state"),
    "render_observation": lambda W, E, S: W.RenderObservation(_counting_rendered(E, S), "rgb"),
    "render_observation_pixels_only": lambda W, E, S: W.RenderObservation(_counting_rendered(E, S), "rgb", pixels_only=True),
    "image_transform": lambda W, E, S: W.ImageTransform(_pixel(E, S, size=16), ["rgb"], 8, True),
}


def _restarting(W, E, S):
    """Crashes at the third step; the replacement runs on."""
    fails_left = [0]
    env = W.RestartOnException(lambda: _flaky(E, S, fails_left), wait=0)
    env.reset()
    env.step(0)
    env.step(0)
    fails_left[0] = 1
    return env


def _mask_base(Env, S):
    """A CartPole-shaped env registered as ``CartPole-v1``."""
    env = _counting(Env, S)
    env.observation_space = S.Box(-np.inf, np.inf, (4,), np.float32)
    env.reset = lambda seed=None, options=None: (np.arange(4, dtype=np.float32) + 1, {})
    env.step = lambda a: (np.arange(4, dtype=np.float32) * 2, 1.0, False, False, {})
    env.spec = gym.envs.registration.EnvSpec("CartPole-v1") if Env is gym.Env else tw.EnvSpec("CartPole-v1")
    return env


def _counting_rendered(Env, S):
    env = _counting(Env, S)
    env.render_mode = "rgb_array"
    env.render = lambda: np.full((6, 6, 3), env._t * 10, np.uint8)
    return env


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_jax(name):
    jenv, tenv = WRAPPERS[name](jw, *JAX), WRAPPERS[name](tw, *PORT)
    actions = [np.array([0.3, -0.1], np.float32) if name in ("frame_stack_dilated", "reward_as_observation", "grayscale_render", "image_transform") else 1] * 14
    _hold(jenv, tenv, actions)
    if name == "grayscale_render":
        np.testing.assert_array_equal(tenv.render(), jenv.render())
        assert tenv.render().shape == (8, 8, 3)
    if name == "action_repeat":
        assert tenv.action_repeat == jenv.action_repeat == 3


@pytest.mark.parametrize(
    "make, error, match",
    [
        (lambda W, E, S: W.ActionRepeat(_counting(E, S), 0), ValueError, "positive integer"),
        (lambda W, E, S: W.FrameStack(_pixel(E, S), 0, ["rgb"]), ValueError, "num_stack"),
        (lambda W, E, S: W.FrameStack(_pixel(E, S), 2, ["rgb"], dilation=0), ValueError, "dilation"),
        (lambda W, E, S: W.FrameStack(_counting(E, S), 2, ["rgb"]), RuntimeError, "Dict"),
        (lambda W, E, S: W.FrameStack(_pixel(E, S), 2, ["depth"]), RuntimeError, "at least one valid cnn key"),
        (lambda W, E, S: W.MaskVelocityWrapper(_counting(E, S)), NotImplementedError, "registered env with a spec"),
        (lambda W, E, S: W.DictObservation(_pixel(E, S), "x"), RuntimeError, "already a Dict"),
        (lambda W, E, S: W.RenderObservation(_counting(E, S), "rgb"), RuntimeError, "render_mode"),
        (lambda W, E, S: W.ImageTransform(_counting(E, S), ["rgb"], 8, False), RuntimeError, "Dict observation space"),
    ],
)
def test_wrapper_errors_match_jax(make, error, match):
    for pkg in ((jw, *JAX), (tw, *PORT)):
        with pytest.raises(error, match=match):
            make(*pkg)


def test_mask_velocity_unknown_id_and_restart_budget(monkeypatch):
    for W, E, S, spec in ((jw, *JAX, gym.envs.registration.EnvSpec("Acrobot-v1")), (tw, *PORT, tw.EnvSpec("Acrobot-v1"))):
        env = _mask_base(E, S)
        env.spec = spec
        with pytest.raises(NotImplementedError, match="not implemented for Acrobot-v1"):
            W.MaskVelocityWrapper(env)
    # the budget: two restarts in the window, the third failure raises; the
    # port keeps the 20 s default pause, patched here
    slept = []
    monkeypatch.setattr(tw.RestartOnException, "sleep", staticmethod(slept.append))
    for W, E, S, kw in ((jw, *JAX, {"wait": 0}), (tw, *PORT, {})):
        env = W.RestartOnException(lambda: _flaky(E, S, [10**9]), maxfails=2, **kw)
        env.reset()
        for _ in range(2):
            with pytest.warns(UserWarning, match="Restarting env after crash"):
                assert env.step(0)[4]["restart_on_exception"] is True
        with pytest.raises(RuntimeError, match="crashed too many times"):
            env.step(0)
    assert slept == [20, 20]


# ------------------------------------------------------------ ImageTransform


@pytest.mark.parametrize(
    "shape, size, gray, tol",
    [
        ((128, 128, 3), 64, True, 0),  # 2x: cv2's fast path
        ((128, 128, 3), 64, False, 0),
        ((64, 64, 3), 16, False, 0),  # 4x: the generic block mean
        ((96, 96, 1), 32, False, 0),  # 3x, one channel
        ((3, 64, 64), 32, True, 0),  # channel-first input
        ((100, 100, 3), 64, False, 1),  # fractional
        ((84, 84, 3), 64, True, 1),
        ((64, 64, 3), 64, True, 0),  # grayscale only
        ((64, 64), 32, False, 0),  # 2-D grayscale frame
    ],
)
def test_image_transform_matches_cv2(shape, size, gray, tol):
    rng = np.random.default_rng(sum(shape) + size)
    frames = rng.integers(0, 256, (4, *shape), dtype=np.uint8)
    got = [tw.ImageTransform.__new__(tw.ImageTransform) for _ in range(2)]
    want = jw.ImageTransform.__new__(jw.ImageTransform)
    for t in (got[0], want):
        t._screen_size, t._grayscale = size, gray
    for f in frames:
        a, b = got[0]._transform(f), want._transform(f)
        assert a.shape == b.shape == (size, size, 1 if gray else 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= tol
    x = np.array([[[r, g, b] for r in range(0, 256, 15) for g in range(0, 256, 5) for b in range(256)]], np.uint8)
    np.testing.assert_array_equal(tw.rgb_to_gray(x), cv2.cvtColor(x, cv2.COLOR_RGB2GRAY))


# ------------------------------------------------------------------ make_env

CASES = {
    "pixel_pendulum": ["env=pixel_pendulum", "env.action_repeat=2", "env.reward_as_observation=True", "env.max_episode_steps=7",
                       "env.frame_stack=3", "env.frame_stack_dilation=2", "env.screen_size=16", "env.wrapper.size=32", "env.grayscale=True"],
    "pixel_pointmass": ["env=pixel_pointmass", "env.screen_size=16", "env.wrapper.size=64", "env.frame_stack=2", "env.max_episode_steps=9"],
    "dummy_discrete": ["env=dummy", "env.id=dummy_discrete", "env.screen_size=16", "algo.mlp_keys.encoder=[state]"],
    "dummy_continuous": ["env=dummy", "env.id=dummy_continuous", "env.screen_size=32", "env.reward_as_observation=True",
                         "algo.mlp_keys.encoder=[state]", "env.max_episode_steps=6"],
    "pixel_catcher": ["env=pixel_catcher", "env.screen_size=16", "env.action_repeat=3", "env.max_episode_steps=10", "env.grayscale=True"],
}


def _cfgs(overrides):
    base = ["exp=dreamer_v3", "algo.cnn_keys.encoder=[rgb]", "env.num_envs=2", "seed=11"]
    return dotdict(jax_compose("config", base + overrides)), dotdict(port_compose("config", base + overrides))


def _inject(jenv, tenv, rng):
    """Both pixel envs draw each episode's first state from one seeded
    stream, in place of their own noise."""
    jbase, tbase = jenv.unwrapped, tenv.unwrapped
    dim = 2 if tbase._spec.env_id.startswith("PixelPendulum") else 4
    states = [rng.uniform(0.2, 0.8, dim).astype(np.float32) for _ in range(32)]
    jstates, tstates = iter(states), iter(states)
    jbase._init = lambda key: {"y": jnp.asarray(next(jstates)), "t": jnp.int32(0)}
    tbase._spec = tbase._spec._replace(init=lambda g, b: _torch_state(next(tstates)))


def _torch_state(y):
    return {"y": torch.from_numpy(y.copy())[None], "t": torch.zeros(1, dtype=torch.int32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_env_matches_jax(case):
    jcfg, tcfg = _cfgs(CASES[case])
    jenv, tenv = jfactory.make_env(jcfg, 5, 0)(), tfactory.make_env(tcfg, 5, 0)()
    if case.startswith("pixel_p"):
        _inject(jenv, tenv, np.random.default_rng(0))
    space = tenv.action_space
    rng = np.random.default_rng(1)
    if isinstance(space, ts.Discrete):
        actions = rng.integers(0, space.n, 40)
    else:
        actions = rng.uniform(-1, 1, (40, *space.shape)).astype(np.float32)
    got, want = _roll(tenv, actions, seed=5), _roll(jenv, actions, seed=5)
    _same_space(tenv.observation_space, jenv.observation_space)
    _same_space(tenv.action_space, jenv.action_space)
    assert len(got) == len(want)
    ended = 0
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _same(g, w)
            continue
        (go, gr, gterm, gtrunc, _), (wo, wr, wterm, wtrunc, _) = g, w
        _same(go, wo)
        assert abs(gr - wr) <= 1e-6 * max(1.0, abs(wr)) and (gterm, gtrunc) == (wterm, wtrunc)
        ended += gterm or gtrunc
    assert ended > 0  # the roll crossed an episode end
    # space draws: in range, the space's dtype, and seeded
    tenv.action_space.seed(3)
    draws = [tenv.action_space.sample() for _ in range(2000)]
    assert all(tenv.action_space.contains(d) for d in draws)
    if isinstance(space, ts.Box):
        d = np.stack(draws)
        bounded = np.isfinite(space.low).all() and np.isfinite(space.high).all()
        want_std = (space.high - space.low).mean() / np.sqrt(12) if bounded else 1.0  # uniform, else normal
        assert d.dtype == np.float32 and abs(d.mean()) < 0.05 and abs(d.std() - want_std) < 0.05
    else:
        assert np.bincount(draws, minlength=space.n).min() > 2000 / space.n * 0.8
    tenv.action_space.seed(3)
    _same(tenv.action_space.sample(), draws[0])


def test_make_env_refusals_name_roadmap_items():
    _, cfg = _cfgs(["env=gym", "env.id=LunarLander-v3"])
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        tfactory.make_env(cfg, 0)()
    _, cfg = _cfgs(["env=crafter"])
    with pytest.raises(NotImplementedError, match="Crafter adapter"):
        tfactory.make_env(cfg, 0)()
    _, cfg = _cfgs(["env=pixel_catcher", "env.capture_video=True"])
    with pytest.raises(NotImplementedError, match="moviepy"):
        tfactory.make_env(cfg, 0, 0, "run")()
    tfactory.make_env(cfg, 0, 0, None)()  # no run dir: no video, as in JAX
    _, cfg = _cfgs(["env=pixel_catcher", "env.backend=pool"])
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tfactory.build_vector_env(cfg, 0)
    for backend, sync_env, want in ((None, False, "async"), (None, True, "sync"), ("SYNC", False, "sync"), ("async", True, "async")):
        assert tfactory.resolve_env_backend({"env": {"backend": backend, "sync_env": sync_env}}) == want
    with pytest.raises(ValueError, match="env.backend"):
        tfactory.resolve_env_backend({"env": {"backend": "ray"}})


# ---------------------------------------------------------------- vector envs


def _vector_roll(envs, actions):
    obs, _ = envs.reset(seed=11)
    rows = [obs]
    for a in actions:
        obs, r, term, trunc, infos = envs.step(a)
        ep = infos.get("final_info", {}).get("episode", {})
        finals = infos.get("final_obs", [None] * envs.num_envs)
        rows.append((obs, r, term, trunc, finals, ep.get("r"), ep.get("l"), ep.get("_r"), infos.get("_final_obs")))
    return rows


def _hold_vectors(got, want):
    assert len(got) == len(want)
    _same(got[0], want[0])
    ended = 0
    for g, w in zip(got[1:], want[1:]):
        _same(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        for gf, wf in zip(g[4], w[4]):
            assert (gf is None) == (wf is None)
            if wf is not None:
                _same(gf, wf)
                ended += 1
        for gi, wi in zip(g[5:], w[5:]):
            assert (gi is None) == (wi is None)
            if wi is not None:
                np.testing.assert_array_equal(gi, wi)
    assert ended > 0


def _vector_actions(space, n, steps, seed=2):
    rng = np.random.default_rng(seed)
    if isinstance(space, (ts.Discrete, gym.spaces.Discrete)):
        return rng.integers(0, space.n, (steps, n))
    return rng.uniform(-1, 1, (steps, n, *space.shape)).astype(np.float32)


@pytest.mark.parametrize("case", ["pixel_catcher", "dummy_continuous"])
def test_sync_vector_env_matches_jax(case):
    jcfg, tcfg = _cfgs(CASES[case] + ["env.backend=sync"])
    jenvs = jfactory.build_vector_env(jcfg, 1, restart_on_exception=True)
    tenvs = tfactory.build_vector_env(tcfg, 1, restart_on_exception=True)
    assert isinstance(tenvs, tvector.SyncVectorEnv)
    _same_space(tenvs.single_observation_space, jenvs.single_observation_space)
    actions = _vector_actions(tenvs.single_action_space, 2, 40)
    _hold_vectors(_vector_roll(tenvs, actions), _vector_roll(jenvs, actions))
    jenvs.close()
    tenvs.close()


def test_async_vector_env_matches_jax():
    """2 spawned workers against the JAX sync vector env (gymnasium's two
    backends share the SAME_STEP semantics), with a per-test timeout."""
    jcfg, tcfg = _cfgs(CASES["pixel_catcher"])
    assert tfactory.resolve_env_backend(tcfg) == "async"  # PixelCatcher's default, as in JAX

    def timed_out(*_):
        raise TimeoutError("the async vector env test ran over 120 s")

    previous = signal.signal(signal.SIGALRM, timed_out)
    signal.alarm(120)
    try:
        thunks = [tfactory.make_env(tcfg, 11 + i, 0, vector_env_idx=i) for i in range(2)]
        tenvs = tvector.AsyncVectorEnv([functools.partial(tw.RestartOnException, t) for t in thunks], timeout=60)
        jcfg.env.backend = "sync"
        jenvs = jfactory.build_vector_env(jcfg, 0, restart_on_exception=True)
        actions = _vector_actions(tenvs.single_action_space, 2, 40)
        _hold_vectors(_vector_roll(tenvs, actions), _vector_roll(jenvs, actions))
        jenvs.close()
        tenvs.close()
        assert all(not p.is_alive() for p in tenvs.processes)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


class FlakyPixelCatcher:
    """Builds a port PixelCatcher whose third step raises once (the env
    ``_target_`` of the restart drill below)."""

    def __new__(cls, **kwargs):
        from sheeprl_tpu_torch.envs.toy import PixelCatcher

        env = PixelCatcher(**kwargs)
        real, calls = env.step, [0]

        def step(action):
            calls[0] += 1
            if calls[0] == 3 and not FlakyPixelCatcher.crashed:
                FlakyPixelCatcher.crashed = True
                raise RuntimeError("env crash")
            return real(action)

        env.step = step
        return env

    crashed = False


def test_restart_surfaces_in_the_vector_infos(monkeypatch):
    monkeypatch.setattr(tw.RestartOnException, "sleep", staticmethod(lambda s: None))
    monkeypatch.setattr(FlakyPixelCatcher, "crashed", False)
    _, cfg = _cfgs(["env=pixel_catcher", "env.screen_size=16", "env.backend=sync"])
    cfg.env.wrapper["_target_"] = f"{__name__}.FlakyPixelCatcher"
    envs = tfactory.build_vector_env(cfg, 0, restart_on_exception=True)
    envs.reset(seed=0)
    flags = []
    for i in range(4):
        with pytest.warns(UserWarning, match="Restarting env") if i == 2 else contextlib.nullcontext():
            *_, infos = envs.step(np.array([1, 1]))
        flags.append(infos.get("restart_on_exception", np.zeros(2, bool)).tolist())
    assert flags == [[False, False], [False, False], [True, False], [False, False]]
    envs.close()


def test_spaces_draw_by_range_dtype_and_frequency():
    box = ts.Box(np.array([-1.0, 0.0, -np.inf, -np.inf]), np.array([1.0, np.inf, 2.0, np.inf]), (4,), np.float32, seed=0)
    d = np.stack([box.sample() for _ in range(4000)])
    assert d.dtype == np.float32 and all(box.contains(x) for x in d[:100])
    assert abs(d[:, 0].mean()) < 0.05 and d[:, 1].min() >= 0 and d[:, 2].max() <= 2 and abs(d[:, 3].mean()) < 0.1
    ints = ts.Box(0, 255, (3,), np.uint8, seed=1)
    u = np.stack([ints.sample() for _ in range(3000)])
    assert u.dtype == np.uint8 and u.min() == 0 and u.max() == 255
    disc = ts.Discrete(4, seed=2)
    counts = np.bincount([disc.sample() for _ in range(4000)], minlength=4)
    assert counts.min() > 850
    dct = ts.Dict({"b": ts.Discrete(3), "a": box})
    assert list(dct.keys()) == ["a", "b"]  # sorted, as gymnasium's Dict
    dct.seed(7)
    first = dct.sample()
    dct.seed(7)
    _same(dct.sample(), first)
    assert dct.contains(first) and not dct.contains({"a": first["a"]})
    assert ts.Box(0, 1, (2,)) == ts.Box(0, 1, (2,)) and ts.Box(0, 1, (2,)) != ts.Box(0, 2, (2,))
    assert repr(ts.Discrete(3)) == "Discrete(3)" and "Box(0.0, 1.0, (2,), float32)" == repr(ts.Box(0, 1, (2,)))
