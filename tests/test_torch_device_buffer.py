"""The port's device ring (sheeprl_tpu_torch/data/device_buffer.py) against
the JAX package's ``DeviceReplayBuffer`` on the JAX CPU backend, case by
case: the same adds from the same seed give the same batches bit for bit,
the same window masks, placement decisions and errors, and the same
checkpoint round trips. The port's ring runs on the CPU here."""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import device_buffer as jdb
from sheeprl_tpu.utils.utils import dotdict
from sheeprl_tpu_torch.data import buffers as tb
from sheeprl_tpu_torch.data import device_buffer as tdb
from sheeprl_tpu_torch.envs import spaces

KEYS = ("rgb", "state")
B, T = 4, 3


def _step(rng, n, screen=4):
    f = lambda *s: rng.standard_normal((1, n, *s)).astype(np.float32)  # noqa: E731
    return {
        "rgb": rng.integers(0, 256, (1, n, screen, screen, 3), dtype=np.uint8),
        "state": f(3),
        "actions": f(2),
        "rewards": f(1),
        "terminated": (rng.random((1, n, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((1, n, 1), np.float32),
        "is_first": np.zeros((1, n, 1), np.float32),
    }


def _feed(rings, n_envs, n_steps, partial, seed=0):
    """``n_steps`` adds of every env; with ``partial``, every third step
    also one env alone (the terminal-step add of the loop)."""
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        data = _step(rng, n_envs)
        for r in rings:
            r.add(data)
        if partial and i % 3 == 1:
            idx = [i % n_envs]
            extra = _step(rng, 1)
            for r in rings:
                r.add(extra, idx)


def _rings(capacity, n_envs, seed=11):
    return (
        jdb.DeviceReplayBuffer(capacity, n_envs=n_envs, obs_keys=KEYS, seed=seed),
        tdb.DeviceReplayBuffer(capacity, n_envs=n_envs, obs_keys=KEYS, device="cpu", seed=seed),
    )


# (capacity, n_envs, steps, partial adds): filling, wrapped past the cursor,
# and cursors apart
CASES = {
    "filling": (16, 2, 9, False),
    "wrapped": (8, 3, 13, False),
    "partial_adds": (8, 3, 11, True),
}


def _assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_batches_equal_the_jax_ring(case):
    capacity, n_envs, steps, partial = CASES[case]
    j, t = _rings(capacity, n_envs)
    _feed((j, t), n_envs, steps, partial)
    np.testing.assert_array_equal(t._pos, j._pos)
    np.testing.assert_array_equal(t._full, j._full)
    _assert_arrays_equal(t.host_arrays(), j.host_arrays())
    assert t.ring_bytes() == j.ring_bytes()
    for got, want in zip(t.sample_batches(B, T, 3), j.sample_batches(B, T, 3)):
        _assert_arrays_equal(got, want)
    # into static inputs, as the per-step train path gathers
    out = {k: torch.empty_like(v) for k, v in next(t.sample_batches(B, T, 1)).items()}
    next(j.sample_batches(B, T, 1))
    got = next(t.sample_batches(B, T, 1, out=out))
    assert got is out
    _assert_arrays_equal(out, next(j.sample_batches(B, T, 1)))


@pytest.mark.parametrize("span", [1, 3, 8])
def test_sequence_start_mask_equals_jax_at_every_fill_level(span):
    capacity = 8
    for full in (False, True):
        for pos in range(capacity):
            p, f = np.array([pos, (pos + 3) % capacity]), np.array([full, full])
            want = np.asarray(jdb.sequence_start_mask(p, f, capacity, span))
            got = tdb.sequence_start_mask(torch.from_numpy(p), torch.from_numpy(f), capacity, span).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"pos {pos} full {full}")


def test_in_graph_draw_yields_valid_windows_uniform_over_envs():
    """The draw the superstep runs: only starts the mask allows, each env
    near its 1/E share (the JAX draw's distribution; the streams differ)."""
    _, t = _rings(8, 3)
    _feed((t,), 3, 11, True)
    bufs, pos, full = t.superstep_inputs(T)
    mask = tdb.sequence_start_mask(pos, full, 8, T)
    env_idx, starts = tdb.draw_from_mask(torch.Generator().manual_seed(0), mask, 3000)
    assert bool(mask[env_idx, starts].all())
    share = torch.bincount(env_idx, minlength=3).double() / 3000
    assert float((share - 1 / 3).abs().max()) < 4 * (1 / 3 * 2 / 3 / 3000) ** 0.5
    batch = tdb.draw_sequence_batch(bufs, pos, full, torch.Generator().manual_seed(0), B, T)
    assert {k: tuple(v.shape[:2]) for k, v in batch.items()} == {k: (T, B) for k in bufs}


def _obs_space(screen):
    return spaces.Dict({"rgb": spaces.Box(0, 255, (screen, screen, 3), np.uint8), "state": spaces.Box(-1, 1, (5,))})


# (buffer.device, backend, buffer.size): auto on the card and on the CPU,
# auto over the budget, forced either way, and an unknown spec
DECISIONS = [
    ("auto", "gpu", 1000),
    ("auto", "cpu", 1000),
    ("auto", "gpu", 10**6),
    ("true", "cpu", 10**6),
    (True, "gpu", 10),
    ("false", "gpu", 10),
    (None, "gpu", 10),
    ("sometimes", "gpu", 10),
]


@pytest.mark.parametrize("spec, backend, size", DECISIONS)
def test_placement_decisions_equal_jax(monkeypatch, spec, backend, size):
    space, actions_dim, n_envs = _obs_space(64), (6,), 4
    buffer_cfg = {"device": spec, "device_max_bytes": 2_000_000_000, "memmap": True}
    fabric = types.SimpleNamespace(num_processes=1, world_size=1, model_axis=None, data_parallel_size=1)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    device = "cuda" if backend == "gpu" else "cpu"
    assert tdb.estimate_ring_bytes(space, actions_dim, size, n_envs) == jdb.estimate_ring_bytes(
        space, actions_dim, size, n_envs
    )
    try:
        want = jdb.resolve_device_buffer(dotdict({"buffer": buffer_cfg}), fabric, space, actions_dim, size, n_envs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0]):
            tdb.resolve_device_buffer({"buffer": buffer_cfg}, device, space, actions_dim, size, n_envs)
        return
    assert tdb.resolve_device_buffer({"buffer": buffer_cfg}, device, space, actions_dim, size, n_envs) == want


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize(
    "call",
    [
        lambda r: r.draw_indices(B, T),
        lambda r: r.superstep_inputs(T),
        lambda r: next(r.sample_batches(B, T, 0)),
        lambda r: r.draw_indices(0, T),
    ],
    ids=["draw_empty", "superstep_empty", "no_samples", "zero_batch"],
)
def test_empty_ring_raises_what_jax_raises(call):
    j, t = _rings(8, 2)
    assert _raised(lambda: call(t)) == _raised(lambda: call(j))


@pytest.mark.parametrize("call", [lambda r: r.superstep_inputs(T), lambda r: r.draw_indices(64, T)], ids=["superstep", "draw"])
def test_short_env_raises_what_jax_raises(call):
    """Env 1 holds one step more than env 0's too few: the host check
    names the first env that cannot give a window."""
    j, t = _rings(8, 2)
    _feed((j, t), 2, 2, False)
    extra = _step(np.random.default_rng(5), 1)
    j.add(extra, [1])
    t.add(extra, [1])
    assert _raised(lambda: call(t)) == _raised(lambda: call(j))


def test_flag_last_truncated_round_trips_as_jax():
    j, t = _rings(8, 3)
    _feed((j, t), 3, 11, True)
    before = t.host_arrays()["truncated"].copy()
    saved_t, saved_j = t.flag_last_truncated(), j.flag_last_truncated()
    np.testing.assert_array_equal(saved_t, np.asarray(saved_j))
    _assert_arrays_equal(t.host_arrays(), j.host_arrays())
    last = (t._pos - 1) % 8
    assert (t.host_arrays()["truncated"][np.arange(3), last] == 1).all()
    t.restore_last_truncated(saved_t)
    j.restore_last_truncated(saved_j)
    np.testing.assert_array_equal(t.host_arrays()["truncated"], before)
    _assert_arrays_equal(t.host_arrays(), j.host_arrays())


@pytest.mark.parametrize("memmap", [False, True])
def test_pickle_and_host_buffer_round_trips(tmp_path, memmap):
    j, t = _rings(8, 3)
    _feed((j, t), 3, 11, True)
    want = t.host_arrays()
    # pickled as host arrays, the generator and the cursors with them
    restored = pickle.loads(pickle.dumps(t))
    assert restored.bufs is None and restored.device is None
    restored.restore_to_device("cpu")
    _assert_arrays_equal(restored.host_arrays(), want)
    np.testing.assert_array_equal(restored._pos, t._pos)
    np.testing.assert_array_equal(restored.draw_indices(B, T)[1], t.draw_indices(B, T)[1])
    # through the port's host buffer and back, as the JAX ring goes through its own
    host = t.to_host_buffer(memmap=memmap, memmap_dir=tmp_path / "mm" if memmap else None)
    assert isinstance(host, tb.EnvIndependentReplayBuffer) and all(host.is_memmap) == memmap
    jhost = j.to_host_buffer()
    for sub, jsub in zip(host.buffer, jhost.buffer):
        assert (sub._pos, sub.full) == (jsub._pos, jsub.full)
        _assert_arrays_equal({k: np.asarray(v) for k, v in sub.buffer.items()}, dict(jsub.buffer))
    back = tdb.DeviceReplayBuffer.from_host_buffer(host, device="cpu", seed=11)
    _assert_arrays_equal(back.host_arrays(), want)
    np.testing.assert_array_equal(back._pos, t._pos)
    np.testing.assert_array_equal(back._full, t._full)


def test_adapt_restored_buffer_moves_between_modes(tmp_path):
    _, t = _rings(8, 3)
    _feed((t,), 3, 11, True)
    want = t.host_arrays()
    host = tdb.adapt_restored_buffer(pickle.loads(pickle.dumps(t)), False, memmap=True, memmap_dir=tmp_path / "a")
    assert isinstance(host, tb.EnvIndependentReplayBuffer) and all(host.is_memmap)
    # a host buffer from a checkpoint holds its arrays in RAM: memmapped again
    again = tdb.adapt_restored_buffer(pickle.loads(pickle.dumps(host)), False, memmap=True, memmap_dir=tmp_path / "b")
    assert all(again.is_memmap)
    ring = tdb.adapt_restored_buffer(again, True, seed=11, device="cpu")
    assert isinstance(ring, tdb.DeviceReplayBuffer)
    _assert_arrays_equal(ring.host_arrays(), want)


# --------------------------------------------------------------------------- #
# the transition half (the SAC family)
# --------------------------------------------------------------------------- #


def _transition_step(rng, n, next_obs=True):
    f = lambda *s: rng.standard_normal((1, n, *s)).astype(np.float32)  # noqa: E731
    out = {"observations": f(3), "actions": f(1), "rewards": f(1), "terminated": (rng.random((1, n, 1)) < 0.2).astype(np.float32), "truncated": np.zeros((1, n, 1), np.float32)}
    if next_obs:
        out["next_observations"] = f(3)
    return out


@pytest.mark.parametrize("sample_next_obs", [False, True])
def test_transition_item_mask_equals_jax_at_every_fill_level(sample_next_obs):
    capacity = 6
    for full in (False, True):
        for pos in range(capacity):
            p, f = np.array([pos, (pos + 2) % capacity, 0]), np.array([full, full, False])
            want = np.asarray(jdb.transition_item_mask(p, f, capacity, sample_next_obs))
            got = tdb.transition_item_mask(torch.from_numpy(p), torch.from_numpy(f), capacity, sample_next_obs).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"pos {pos} full {full}")


@pytest.mark.parametrize("sample_next_obs, steps", [(False, 5), (False, 11), (True, 11)])
def test_transition_samples_equal_the_jax_ring(sample_next_obs, steps):
    """The same adds from the same seed: the same ``[n, B]`` transitions
    bit for bit (``next_observations`` from the next item when sampled),
    before and after the ring wraps."""
    j = jdb.DeviceReplayBuffer(8, n_envs=3, obs_keys=("observations",), seed=5)
    t = tdb.DeviceReplayBuffer(8, n_envs=3, obs_keys=("observations",), device="cpu", seed=5)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        data = _transition_step(rng, 3, next_obs=not sample_next_obs)
        j.add(data)
        t.add(data)
    for n in (1, 3):
        _assert_arrays_equal(t.sample_transitions(B, n, sample_next_obs), j.sample_transitions(B, n, sample_next_obs))


def test_transition_errors_match_jax():
    for sample_next_obs in (False, True):
        j = jdb.DeviceReplayBuffer(4, n_envs=2, seed=0)
        t = tdb.DeviceReplayBuffer(4, n_envs=2, device="cpu", seed=0)
        for ring in (j, t):
            with pytest.raises(RuntimeError, match="not been initialized"):
                ring.sample_transitions(B)
            ring.add(_transition_step(np.random.default_rng(0), 2))
        if sample_next_obs:  # one step stored: no next observation yet
            with pytest.raises(ValueError) as je:
                j.sample_transitions(B, sample_next_obs=True)
            with pytest.raises(ValueError) as te:
                t.sample_transitions(B, sample_next_obs=True)
            assert str(je.value) == str(te.value)
            with pytest.raises(ValueError, match="at least two samples"):
                t.superstep_inputs(sample_next_obs=True)


@pytest.mark.parametrize("sample_next_obs", [False, True])
def test_arithmetic_transition_draw_equals_the_mask_draw(sample_next_obs):
    """``draw_transition_items`` maps the same generator draws to the same
    items as ``draw_from_mask`` over ``transition_item_mask``, at every fill
    level, cursors apart."""
    capacity = 7
    for full in (False, True):
        for pos in range(capacity):
            p = torch.tensor([pos, (pos + 3) % capacity, max(pos, 2)])
            f = torch.tensor([full, full, False])
            mask = tdb.transition_item_mask(p, f, capacity, sample_next_obs)
            want = tdb.draw_from_mask(torch.Generator().manual_seed(pos), mask, 500)
            got = tdb.draw_transition_items(torch.Generator().manual_seed(pos), p, f, capacity, 500, sample_next_obs)
            if bool(mask.any(1).all()):
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_in_graph_transition_draw_is_uniform_over_envs_and_valid_items():
    """``draw_transition_batch``: only items the mask allows, each env near
    1/E and, within an env, each valid item near 1/valid (the JAX draw's
    distribution; the streams differ); ``next_<key>`` at the next item."""
    t = tdb.DeviceReplayBuffer(8, n_envs=2, obs_keys=("observations",), device="cpu", seed=0)
    rng = np.random.default_rng(2)
    for _ in range(5):
        t.add(_transition_step(rng, 2, next_obs=False))
    bufs, pos, full = t.superstep_inputs(sample_next_obs=True)
    n = 8000
    mask = tdb.transition_item_mask(pos, full, 8, True)
    env_idx, items = tdb.draw_transition_items(torch.Generator().manual_seed(3), pos, full, 8, n, True)
    assert bool(mask[env_idx, items].all()) and int(mask.sum()) == 8
    freq = torch.zeros(2, 8, dtype=torch.float64).index_put_((env_idx, items), torch.ones(n, dtype=torch.float64), accumulate=True) / n
    sigma = (1 / 8 * 7 / 8 / n) ** 0.5
    assert float((freq[mask] - 1 / 8).abs().max()) < 5 * sigma
    batch = tdb.draw_transition_batch(bufs, pos, full, torch.Generator().manual_seed(3), 64, True, ("observations",))
    assert batch["next_observations"].shape == (64, 3)
    obs = bufs["observations"]
    for o, nx in zip(batch["observations"], batch["next_observations"]):
        (e, i) = [int(a[0]) for a in torch.nonzero((obs == o).all(-1), as_tuple=True)]
        assert torch.equal(obs[e, i + 1], nx)


@pytest.mark.parametrize("memmap", [False, True])
def test_transition_host_buffer_round_trips_as_jax(tmp_path, memmap):
    """ring -> plain ``ReplayBuffer`` -> ring, both packages: the same
    arrays, cursors and samples; a ring written by partial adds refuses."""
    j = jdb.DeviceReplayBuffer(6, n_envs=2, obs_keys=("observations",), seed=4)
    t = tdb.DeviceReplayBuffer(6, n_envs=2, obs_keys=("observations",), device="cpu", seed=4)
    rng = np.random.default_rng(3)
    for _ in range(9):
        data = _transition_step(rng, 2)
        j.add(data)
        t.add(data)
    jh = j.to_transition_host_buffer(memmap=memmap, memmap_dir=tmp_path / "j")
    th = t.to_transition_host_buffer(memmap=memmap, memmap_dir=tmp_path / "t")
    assert isinstance(th, tb.ReplayBuffer) and th.is_memmap == memmap
    assert (th._pos, th.full) == (jh._pos, jh.full) == (3, True)
    _assert_arrays_equal({k: np.asarray(v) for k, v in th.buffer.items()}, {k: np.asarray(v) for k, v in jh.buffer.items()})
    back_t = tdb.DeviceReplayBuffer.from_transition_host_buffer(th, device="cpu", seed=8)
    back_j = jdb.DeviceReplayBuffer.from_transition_host_buffer(jh, seed=8)
    _assert_arrays_equal(back_t.host_arrays(), back_j.host_arrays())
    _assert_arrays_equal(back_t.sample_transitions(B, 2), back_j.sample_transitions(B, 2))
    # the restore path: a pickled plain buffer into a ring and back
    restored = tdb.adapt_restored_buffer(pickle.loads(pickle.dumps(th)), True, seed=8, device="cpu", mode="transition")
    _assert_arrays_equal(restored.host_arrays(), back_t.host_arrays())
    host = tdb.adapt_restored_buffer(pickle.loads(pickle.dumps(restored)), False, mode="transition")
    assert isinstance(host, tb.ReplayBuffer) and host._pos == 3
    t.add(_transition_step(rng, 1), [0])
    with pytest.raises(RuntimeError, match="lockstep"):
        t.to_transition_host_buffer()


def test_transition_footprint_and_placement_equal_jax(monkeypatch):
    space = _obs_space(8)
    for keys, store_next in ((["state"], True), (["rgb", "state"], False)):
        want = jdb.estimate_transition_bytes(space, keys, (2,), 100, 4, store_next)
        assert tdb.estimate_transition_bytes(space, keys, (2,), 100, 4, store_next) == want
    # exp=sac at 1M on 4 envs fits the default budget; exp=sac_ae does not
    pendulum = spaces.Dict({"state": spaces.Box(-1, 1, (3,))})
    assert tdb.estimate_transition_bytes(pendulum, ["state"], (1,), 250000, 4, True) == 40 * 10**6
    pixels = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64, 3), np.uint8)})
    assert tdb.estimate_transition_bytes(pixels, ["rgb"], (1,), 250000, 4, True) > 8 * 10**9
    cfg = {"buffer": {"device": "auto", "memmap": False, "device_max_bytes": 8_000_000_000}}
    ring = tdb.make_transition_replay(cfg, "cpu", pendulum, ["state"], (1,), 16, 4, ("observations",), None, 0, True)
    assert isinstance(ring, tb.ReplayBuffer)  # auto never picks the ring on the CPU
    cfg["buffer"]["device"] = True
    ring = tdb.make_transition_replay(cfg, "cpu", pendulum, ["state"], (1,), 16, 4, ("observations",), None, 0, True)
    assert isinstance(ring, tdb.DeviceReplayBuffer)
