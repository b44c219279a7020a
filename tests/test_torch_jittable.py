"""The port's pure envs (sheeprl_tpu_torch/envs/jittable.py and
jittable_pixels.py) against the JAX package's, on the same states and
actions made with numpy from a seed.

Bounds: teacher-forced steps (both packages step the same state) within
``STEP_TOL`` 1e-6 on state, obs and reward (absolute, and relative above 1,
where a float32 ulp is larger), flags exact; a 200-step trajectory each
package runs on its own within ``TRAJ_TOL`` 1e-4 where the dynamics do not
amplify rounding (``test_spec_trajectory``). Frames:
equal, except a pixel whose float64 distance lies within ``EDGE_TOL`` 1e-5
of its mask's edge (XLA may contract the float32 sums to FMAs where torch
does not), at most ``EDGE_SHARE`` 0.1% of the pixels. ``init`` draws from a
torch generator, so it is held by range and frequency.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs import jittable as jj
from sheeprl_tpu.envs import jittable_pixels as jjp
from sheeprl_tpu_torch.envs import jittable as tj
from sheeprl_tpu_torch.envs import jittable_pixels as tjp

STEP_TOL = 1e-6
TRAJ_TOL = 1e-4
EDGE_TOL = 1e-5
EDGE_SHARE = 1e-3
N = 256
SIZE = 32


def _jax_batched(fn):
    return jax.jit(jax.vmap(fn, in_axes=(0, 0, None)))


def _states(env_id, rng, n):
    """Seeded states across each env's range, ``t`` reaching its limit."""
    if env_id.startswith("CartPole"):
        y = rng.uniform(-1, 1, (n, 4)) * np.array([2.6, 3.0, 0.23, 3.0])
        t = rng.integers(480, 500, n)
    elif env_id.startswith("PixelPointmass"):
        y = np.concatenate([rng.uniform(-0.05, 1.05, (n, 2)), rng.uniform(-0.1, 0.1, (n, 2))], -1)
        t = rng.integers(90, 100, n)
    else:
        y = np.stack([rng.uniform(-8, 8, n), rng.uniform(-9, 9, n)], -1)
        t = rng.integers(190, 200, n)
    return y.astype(np.float32), t.astype(np.int32)


def _actions(spec, rng, n):
    if not spec.is_continuous:
        return rng.integers(0, spec.action_dim, n).astype(np.int32)
    return rng.uniform(-3, 3, (n, spec.action_dim)).astype(np.float32)


def _step_both(jspec, tspec, y, t, a):
    state, out = _jax_batched(jspec.step)({"y": jnp.asarray(y), "t": jnp.asarray(t)}, jnp.asarray(a), jax.random.PRNGKey(0))
    tstate, tout = tspec.step({"y": torch.from_numpy(y), "t": torch.from_numpy(t)}, torch.from_numpy(a))
    return (state, out), (tstate, tout)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_spec_step_teacher_forced(env_id):
    rng = np.random.default_rng(0)
    jspec, tspec = jj.get_jittable_env(env_id), tj.get_jittable_env(env_id)
    assert (tspec.obs_dim, tspec.is_continuous, tspec.action_dim, tspec.max_episode_steps) == (
        jspec.obs_dim,
        jspec.is_continuous,
        jspec.action_dim,
        jspec.max_episode_steps,
    )
    y, t = _states(env_id, rng, N)
    (state, out), (tstate, tout) = _step_both(jspec, tspec, y, t, _actions(jspec, rng, N))
    np.testing.assert_allclose(tstate["y"].numpy(), np.asarray(state["y"]), atol=STEP_TOL, rtol=STEP_TOL)
    np.testing.assert_array_equal(tstate["t"].numpy(), np.asarray(state["t"]))
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(out.obs), atol=STEP_TOL, rtol=STEP_TOL)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(out.reward), atol=STEP_TOL, rtol=STEP_TOL)
    for got, want in ((tout.terminated, out.terminated), (tout.truncated, out.truncated)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if env_id.startswith("CartPole"):
        assert 0 < tout.terminated.sum() < N  # the states straddle the thresholds
    assert 0 < tout.truncated.sum() < N
    np.testing.assert_allclose(tspec.observation(tstate).numpy(), np.asarray(jax.vmap(jspec.observation)(state)), atol=STEP_TOL)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1", "PixelPendulum-v0", "PixelPointmass-v0"])
def test_spec_trajectory(env_id):
    """200 steps of seeded actions from the same initial states. (a) Every
    state of the JAX trajectory, stepped by the port (teacher-forced),
    within STEP_TOL. (b) Each package on its own for 200 steps within
    TRAJ_TOL where the dynamics do not amplify rounding: the pendulums with
    small torques from hanging (sin and cos differ between XLA and torch by
    an ulp, and a spinning pendulum or a falling pole doubles that every
    few steps, so no two float32 programs agree there after 200 steps),
    the damped point mass with any force."""
    rng = np.random.default_rng(1)
    n = 16
    jspec, tspec = jj.get_jittable_env(env_id), tj.get_jittable_env(env_id)
    if env_id.startswith("Pixel"):
        jspec, tspec = jjp._compiled(env_id, 16)[0], tjp._compiled(env_id, 16)
    y = np.array(jax.vmap(jspec.init)(jax.random.split(jax.random.PRNGKey(3), n))["y"])
    if "Pendulum" in env_id:
        y[:, 0] = np.float32(np.pi) + y[:, 0] / np.float32(10)  # near hanging, slow
        y[:, 1] /= np.float32(10)
    step = _jax_batched(jspec.step)
    jstate = {"y": jnp.asarray(y), "t": jnp.zeros(n, jnp.int32)}
    tstate = {"y": torch.from_numpy(y.copy()), "t": torch.zeros(n, dtype=torch.int32)}
    ys, ts, acts, next_ys = [], [], [], []
    for _ in range(200):
        a = _actions(jspec, rng, n)
        if "Pendulum" in env_id:
            a = a / np.float32(6.0)  # |u| <= 0.5
        ys.append(np.asarray(jstate["y"]))
        ts.append(np.asarray(jstate["t"]))
        acts.append(a)
        jstate, _ = step(jstate, jnp.asarray(a), jax.random.PRNGKey(0))
        next_ys.append(np.asarray(jstate["y"]))
        tstate, _ = tspec.step(tstate, torch.from_numpy(a))
    # (a) teacher-forced over the whole JAX trajectory, one batch
    forced, out = tspec.step(
        {"y": torch.from_numpy(np.concatenate(ys)), "t": torch.from_numpy(np.concatenate(ts))},
        torch.from_numpy(np.concatenate(acts)),
    )
    np.testing.assert_allclose(forced["y"].numpy(), np.concatenate(next_ys), atol=STEP_TOL, rtol=STEP_TOL)
    # (b) free-running
    if not env_id.startswith("CartPole"):
        np.testing.assert_allclose(tstate["y"].numpy(), np.asarray(jstate["y"]), atol=TRAJ_TOL, rtol=0)
    np.testing.assert_array_equal(tstate["t"].numpy(), np.asarray(jstate["t"]))


def _edge_distance(env_id, y, size):
    """float64 ``|d^2 - r^2|`` of every pixel to each mask edge of the
    frame of state ``y``: the nearest edge per pixel."""
    px = (np.arange(size) + 0.5) / size
    xx, yy = np.meshgrid(px, px, indexing="xy")
    gaps = []
    if env_id.startswith("PixelPointmass"):
        for (cx, cy), r in (((0.5, 0.5), 4 / 64), ((y[0], y[1]), 5 / 64)):
            gaps.append(np.abs((xx - cx) ** 2 + (yy - cy) ** 2 - r**2))
    else:
        th = float(y[0])
        dx, dy = 0.35 * np.sin(th), -0.35 * np.cos(th)
        tt = np.clip(((xx - 0.5) * dx + (yy - 0.5) * dy) / (dx * dx + dy * dy + 1e-12), 0, 1)
        gaps.append(np.abs((xx - 0.5 - tt * dx) ** 2 + (yy - 0.5 - tt * dy) ** 2 - (1.6 / 64) ** 2))
        gaps.append(np.abs((xx - 0.5) ** 2 + (yy - 0.5) ** 2 - (2.5 / 64) ** 2))
    return np.min(gaps, axis=0)


def _hold_frames(env_id, got, want, ys, size):
    """Frames equal but for pixels on a mask edge, at most EDGE_SHARE."""
    diff = np.any(got != want, axis=-1)
    for b in np.nonzero(diff.any(axis=(1, 2)))[0]:
        gap = _edge_distance(env_id, ys[b], size)
        assert np.all(gap[diff[b]] <= EDGE_TOL), f"frame {b}: a pixel off the mask edge differs"
    assert diff.mean() <= EDGE_SHARE, diff.mean()
    return int(diff.sum())


@pytest.mark.parametrize("env_id", ["PixelPendulum-v0", "PixelPointmass-v0"])
def test_pixel_frames_and_steps(env_id):
    rng = np.random.default_rng(2)
    jspec, tspec = jjp._compiled(env_id, SIZE)[0], tjp._compiled(env_id, SIZE)
    assert tspec.obs_shape == jspec.obs_shape == (SIZE, SIZE, 3)
    y, t = _states(env_id, rng, N)
    # the frame of a state
    want = np.asarray(jax.jit(jax.vmap(jspec.observation))({"y": jnp.asarray(y), "t": jnp.asarray(t)}))
    got = tspec.observation({"y": torch.from_numpy(y), "t": torch.from_numpy(t)}).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    _hold_frames(env_id, got, want, y, SIZE)
    assert (want > 0).any(axis=-1).mean() > 0.005  # the discs and rods are drawn
    # a teacher-forced step: state, reward, flags, and the next frame
    (state, out), (tstate, tout) = _step_both(jspec, tspec, y, t, _actions(jspec, rng, N))
    np.testing.assert_allclose(tstate["y"].numpy(), np.asarray(state["y"]), atol=STEP_TOL, rtol=STEP_TOL)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(out.reward), atol=STEP_TOL, rtol=STEP_TOL)
    np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(out.truncated))
    np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(out.terminated))
    _hold_frames(env_id, tout.obs.numpy(), np.asarray(out.obs), np.asarray(state["y"]), SIZE)


@pytest.mark.parametrize(
    "env_id, lows, highs",
    [
        ("CartPole-v1", [-0.05] * 4, [0.05] * 4),
        ("Pendulum-v1", [-np.pi, -1.0], [np.pi, 1.0]),
        ("PixelPointmass-v0", [0.1, 0.1, 0, 0], [0.9, 0.9, 0, 0]),
    ],
)
def test_init_range_and_frequency(env_id, lows, highs):
    """10^4 draws inside the JAX init's range, each bounded axis uniform:
    every one of 10 bins within 5 sigma of n/10; the same seed draws the
    same states, another seed others."""
    spec = tj.get_jittable_env(env_id)
    n, bins = 10_000, 10
    state = spec.init(torch.Generator().manual_seed(0), n)
    y = state["y"].numpy()
    assert y.shape == (n, len(lows)) and y.dtype == np.float32
    assert state["t"].dtype == torch.int32 and not state["t"].any()
    jy = np.asarray(jax.vmap(jj.get_jittable_env(env_id).init)(jax.random.split(jax.random.PRNGKey(0), 64))["y"])
    assert jy.shape[1:] == y.shape[1:]
    for col, (lo, hi) in enumerate(zip(lows, highs)):
        assert np.all(y[:, col] >= np.float32(lo)) and np.all(y[:, col] <= np.float32(hi))
        assert np.all(jy[:, col] >= np.float32(lo)) and np.all(jy[:, col] <= np.float32(hi))
        if hi > lo:
            counts, _ = np.histogram(y[:, col], bins=bins, range=(lo, hi))
            sigma = np.sqrt(n / bins * (1 - 1 / bins))
            assert np.all(np.abs(counts - n / bins) <= 5 * sigma), counts
    again = spec.init(torch.Generator().manual_seed(0), n)["y"]
    assert torch.equal(again, state["y"])
    assert not torch.equal(spec.init(torch.Generator().manual_seed(1), n)["y"], state["y"])


def test_angle_normalize_is_floor_mod():
    x = np.array([-10.0, -7.0, -np.pi, -3.0, 0.0, 3.0, np.pi, 7.0, 10.0], np.float32)
    got = tj._angle_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jj._angle_normalize(jnp.asarray(x))), atol=STEP_TOL)
    assert np.all(got >= -np.float32(np.pi)) and np.all(got < np.float32(np.pi) + 1e-6)


def test_registry_and_physics():
    assert tj.PHYSICS_FACTORIES.keys() == jj.PHYSICS_FACTORIES.keys()
    for env_id in ("CartPole-v1", "Pendulum-v1", "PixelPendulum-v0", "PixelPointmass-v0"):
        assert tj.get_jittable_env(env_id).env_id == env_id
    assert tj.get_jittable_env("Acrobot-v1") is None
    # a physics variant: the same overrides step the same
    rng = np.random.default_rng(4)
    for env_id in tj.PHYSICS_FACTORIES:
        jspec = jj.PHYSICS_FACTORIES[env_id](1.3, 0.8, 1.2)
        tspec = tj.PHYSICS_FACTORIES[env_id](1.3, 0.8, 1.2)
        y, t = _states(env_id, rng, 32)
        (state, _), (tstate, _) = _step_both(jspec, tspec, y, t, _actions(jspec, rng, 32))
        np.testing.assert_allclose(tstate["y"].numpy(), np.asarray(state["y"]), atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("env_id", ["PixelPendulum-v0", "PixelPointmass-v0"])
def test_host_adapter_matches_jax(env_id):
    """``JittablePixelEnv`` stepped from the JAX adapter's state at every
    step of a whole episode: spaces, frames, rewards and truncation equal
    to the JAX adapter's."""
    rng = np.random.default_rng(5)
    jenv, tenv = jjp.JittablePixelEnv(env_id, 16, seed=3), tjp.JittablePixelEnv(env_id, 16, seed=3)
    assert tenv.observation_space["rgb"].shape == jenv.observation_space["rgb"].shape
    assert tenv.action_space.shape == jenv.action_space.shape
    assert tenv.observation_space["rgb"].dtype == jenv.observation_space["rgb"].dtype
    obs, _ = tenv.reset(seed=3)
    assert obs["rgb"].shape == (16, 16, 3) and tenv.observation_space["rgb"].contains(obs["rgb"])
    jenv.reset(seed=3)
    y0 = np.asarray(jenv._state["y"])
    tenv.set_state(y0)
    np.testing.assert_array_equal(tenv.render(), jenv.render())
    trunc = False
    steps = 0
    while not trunc:
        a = rng.uniform(-1, 1, tenv.action_space.shape).astype(np.float32)
        tenv.set_state(np.asarray(jenv._state["y"]), int(jenv._state["t"]))
        jo, jr, jterm, jtrunc, _ = jenv.step(a)
        to, tr, tterm, trunc, _ = tenv.step(a)
        np.testing.assert_array_equal(to["rgb"], jo["rgb"])
        assert abs(tr - jr) <= STEP_TOL * max(1.0, abs(jr)) and (tterm, trunc) == (jterm, jtrunc)
        steps += 1
    assert steps == tj.get_jittable_env(env_id).max_episode_steps
