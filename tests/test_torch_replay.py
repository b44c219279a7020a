"""The port's sequence replay and replay ratio (sheeprl_tpu_torch/data and
utils) against the JAX package's: one seed gives the same windows from the
same stored steps (the buffers draw from the same numpy Generator calls),
and ``Ratio`` the same gradient steps."""

import contextlib
import types

import numpy as np
import pytest

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.utils.utils import Ratio as JRatio
from sheeprl_tpu_torch.data import buffers as tb
from sheeprl_tpu_torch.utils.utils import Ratio


def _steps(rng, n_steps, n_envs):
    """``n_steps`` single-step adds for ``n_envs`` envs, as the loop makes them."""
    for i in range(n_steps):
        yield {
            "rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 3)).astype(np.uint8),
            "actions": rng.standard_normal((1, n_envs, 2)).astype(np.float32),
            "rewards": np.full((1, n_envs, 1), i, np.float32),
            "is_first": (rng.uniform(size=(1, n_envs, 1)) < 0.1).astype(np.float32),
        }


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_steps", [12, 40])  # before and after the 16-slot buffer wraps
def test_env_independent_sequential_windows_match(n_steps):
    rng = np.random.default_rng(0)
    j = jb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), buffer_cls=jb.SequentialReplayBuffer, seed=7)
    t = tb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), buffer_cls=tb.SequentialReplayBuffer, seed=7)
    for i, step in enumerate(_steps(rng, n_steps, 3)):
        j.add(step)
        t.add(step)
        if i % 5 == 4:  # one env's episode ends: its terminal step alone
            last = {k: v[:, 1:2] for k, v in step.items()}
            j.add(last, [1])
            t.add(last, [1])
    for _ in range(3):
        got = t.sample(5, sequence_length=4, n_samples=2)
        want = j.sample(5, sequence_length=4, n_samples=2)
        assert got["rgb"].shape == (2, 4, 5, 4, 4, 3)
        _assert_same(got, want)
    # windows are contiguous in time within one env
    r = got["rewards"][..., 0]
    assert np.all((np.diff(r, axis=1) == 1) | (np.diff(r, axis=1) == 0))


@pytest.mark.parametrize("full", [False, True])
def test_sequential_and_uniform_buffers_match(full):
    rng = np.random.default_rng(1)
    n = 30 if full else 9
    for jcls, tcls, kw in (
        (jb.SequentialReplayBuffer, tb.SequentialReplayBuffer, {"sequence_length": 3}),
        (jb.ReplayBuffer, tb.ReplayBuffer, {"sample_next_obs": True}),
    ):
        j, t = jcls(12, n_envs=2, obs_keys=("rgb",), seed=3), tcls(12, n_envs=2, obs_keys=("rgb",), seed=3)
        for step in _steps(rng, n, 2):
            j.add(step)
            t.add(step)
        assert t.full == j.full == full
        _assert_same(t.sample(6, n_samples=2, **kw), j.sample(6, n_samples=2, **kw))


def test_sequential_buffer_refuses_what_the_reference_refuses():
    t = tb.SequentialReplayBuffer(8, n_envs=1, seed=0)
    with pytest.raises(RuntimeError):
        t.sample(2, sequence_length=2)
    for step in _steps(np.random.default_rng(2), 3, 1):
        t.add(step)
    with pytest.raises(ValueError, match="length 4"):
        t.sample(2, sequence_length=4)


@pytest.mark.parametrize("ratio, pretrain", [(1.0, 0), (0.5, 0), (0.25, 8), (2.0, 100)])
def test_ratio_matches(ratio, pretrain):
    jr, tr = JRatio(ratio, pretrain_steps=pretrain), Ratio(ratio, pretrain_steps=pretrain)
    steps = [4 * i for i in range(1, 60)]
    with pytest.warns(UserWarning) if pretrain > 4 else contextlib.nullcontext():
        got = [tr(s) for s in steps]
    with pytest.warns(UserWarning) if pretrain > 4 else contextlib.nullcontext():
        want = [jr(s) for s in steps]
    assert got == want
    assert tr.state_dict() == jr.state_dict()
    assert Ratio(3.0).load_state_dict(jr.state_dict()).state_dict() == jr.state_dict()



def _filled(seed=7, n_steps=30):
    rb = tb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), buffer_cls=tb.SequentialReplayBuffer, seed=seed)
    for step in _steps(np.random.default_rng(0), n_steps, 3):
        rb.add(step)
    return rb


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetched_batches_are_the_buffer_draws_in_order(depth):
    """The prefetcher's sampler thread draws from the buffer's Generator in
    the same order as a synchronous loop and as the JAX package's prefetcher:
    batch i lands in the static inputs as ``sample(...)[0]``, pixels uint8
    and the rest fp32, across windows."""
    import torch

    from sheeprl_tpu.data.prefetch import sampled_batches as j_sampled_batches
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import batch_inputs
    from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher

    rb, ref, jref = _filled(), _filled(), jb.EnvIndependentReplayBuffer(
        16, n_envs=3, obs_keys=("rgb",), buffer_cls=jb.SequentialReplayBuffer, seed=7
    )
    for step in _steps(np.random.default_rng(0), 30, 3):
        jref.add(step)
    inputs = batch_inputs(rb, 4, 5, ["rgb"], torch.device("cpu"))
    assert inputs["rgb"].dtype == torch.uint8 and inputs["rewards"].dtype == torch.float32
    pre = BatchPrefetcher(rb, 5, 4, inputs, depth=depth)
    fabric = types.SimpleNamespace(num_processes=1, world_size=1)
    jax_batches = j_sampled_batches(jref, 5, 4, 7, ["rgb"], fabric, prefetch=2)
    for n in (3, 4):  # two train windows
        for got in pre.sampled_batches(n):
            want = ref.sample(5, sequence_length=4, n_samples=1)
            jwant = next(jax_batches)
            assert got is inputs
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v[0].astype(got[k].numpy().dtype), err_msg=k)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(jwant[k]), err_msg=k)


def test_prefetch_sampler_errors_surface_and_the_window_can_end_early():
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import batch_inputs
    from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher

    rb = _filled()
    inputs = batch_inputs(rb, 4, 5, ["rgb"], torch.device("cpu"))
    pre = BatchPrefetcher(rb, 5, 40, inputs, depth=2)  # 40 > the 16 stored steps
    with pytest.raises(RuntimeError, match="prefetch sampler failed"):
        next(iter(pre.sampled_batches(2)))
    ok = BatchPrefetcher(rb, 5, 4, inputs, depth=2)
    for i, _ in enumerate(ok.sampled_batches(5)):
        if i == 1:
            break
    assert sorted(ok._free.queue) == [0, 1]  # every host buffer back with the sampler
    assert len(list(ok.sampled_batches(3))) == 3


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetched_stacks_are_the_buffer_draws_in_order(depth):
    """With ``n_samples`` (a fused superstep's ``[K, T, B, ...]`` inputs on
    the host buffer) each item is one ``sample(n_samples=K)`` draw, in the
    buffer's order, as the JAX package's pregathered stack."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import batch_inputs
    from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher

    rb, ref = _filled(), _filled()
    stack = batch_inputs(rb, 4, 5, ["rgb"], torch.device("cpu"), stack=3)
    assert stack["rgb"].shape == (3, 4, 5, 4, 4, 3)
    pre = BatchPrefetcher(rb, 5, 4, stack, depth=depth, n_samples=3)
    for n in (2, 1):  # two train windows
        for got in pre.sampled_batches(n):
            want = ref.sample(5, sequence_length=4, n_samples=3)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v.astype(got[k].numpy().dtype), err_msg=k)
