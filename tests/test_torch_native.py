"""The port's native replay gather (``sheeprl_tpu_torch/native``: its own
``gather.cpp``, built with g++ at first use) on the CPU.

Held bit for bit: ``gather_rows`` and ``gather_sequences`` against numpy's
fancy indexing (their plain version) and against the JAX package's
``sheeprl_tpu.native``, over dtypes, item shapes, wrapping windows, the
next-observation shift and a memmapped source; the inputs the kernel does
not take return None, as the JAX functions do; the host buffers' batches
through the kernel against the same draws gathered by numpy. Unlike the
JAX loader, a build that fails raises with the compiler's error.
"""

import numpy as np
import pytest

from sheeprl_tpu import native as jax_native
from sheeprl_tpu_torch import native
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

DTYPES = [np.uint8, np.float32, np.float64, np.int64, np.bool_]


def _ring(rng, dtype, size, n_envs, item):
    return (rng.standard_normal((size, n_envs, *item)) * 50).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("item", [(), (3,), (2, 5, 4)])
def test_gathers_equal_numpy_and_the_jax_kernel(dtype, item):
    rng = np.random.default_rng(0)
    src = _ring(rng, dtype, 23, 3, item)
    rows, envs = rng.integers(0, 60, 17), rng.integers(0, 3, 17)
    got = native.gather_rows(src, rows, envs)
    np.testing.assert_array_equal(got, src[rows % 23, envs])
    np.testing.assert_array_equal(got, jax_native.gather_rows(src, rows, envs))
    starts, envs, L = rng.integers(0, 23, 6), rng.integers(0, 3, 6), 9  # windows wrap the ring
    for shift in (0, 1):
        got = native.gather_sequences(src, starts, envs, L, 2, 3, shift)
        idx = (starts[:, None] + shift + np.arange(L)) % 23
        want = src[idx, np.repeat(envs[:, None], L, axis=1)].reshape(2, 3, L, *item).swapaxes(1, 2)
        assert got.flags.c_contiguous and got.shape == (2, L, 3, *item)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_native.gather_sequences(src, starts, envs, L, 2, 3, shift))


def test_a_memmapped_source_gathers_as_numpy(tmp_path):
    src = np.memmap(tmp_path / "ring.dat", dtype=np.float32, mode="w+", shape=(11, 2, 4))
    src[:] = np.arange(src.size, dtype=np.float32).reshape(src.shape)
    rows, envs = np.array([10, 0, 5]), np.array([1, 0, 1])
    np.testing.assert_array_equal(native.gather_rows(src, rows, envs), src[rows, envs])


def test_inputs_the_kernel_does_not_take_return_none_as_jax():
    rng = np.random.default_rng(1)
    ring = _ring(rng, np.float32, 8, 2, (3,))
    rows, envs = np.array([1, 2]), np.array([0, 1])
    for src in (ring[:, :, ::2], np.empty((8, 2), dtype=object), np.zeros(8, np.float32)):
        assert native.gather_rows(src, rows, envs) is None and jax_native.gather_rows(src, rows, envs) is None
        assert native.gather_sequences(src, rows, envs, 2, 1, 2) is None
    assert native.gather_rows(np.zeros((8, 2, 0), np.float32), rows, envs) is None
    with pytest.raises(ValueError, match="starts"):
        native.gather_sequences(ring, rows, envs, 2, 2, 2)


def test_a_failed_build_raises_with_the_compilers_error(tmp_path, monkeypatch):
    bad = tmp_path / "gather.cpp"
    bad.write_text("int gather_rows( { this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(native.NativeBuildError, match="error"):
        native.gather_rows(np.zeros((4, 1, 2), np.float32), np.array([0]), np.array([0]))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    bad.write_text("// another source, so no cached build\n")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        native.build()


def _filled(cls, rng, **kw):
    rb = cls(32, n_envs=2, obs_keys=("obs",), seed=3, **kw)
    for _ in range(3):
        rb.add({"obs": rng.integers(0, 255, (20, 2, 3, 4), dtype=np.uint8), "rewards": rng.standard_normal((20, 2, 1)).astype(np.float32)})
    return rb


@pytest.mark.parametrize(
    "cls, kw",
    [(ReplayBuffer, {"sample_next_obs": True}), (SequentialReplayBuffer, {"sequence_length": 7}), (EnvIndependentReplayBuffer, {"sequence_length": 5})],
)
def test_the_buffers_gather_through_the_kernel_bit_equal_to_numpy(cls, kw, monkeypatch):
    """The same seeded buffer sampled twice, through the kernel and with
    the kernel patched away (numpy): the same draws, bit-equal batches."""
    extra = {"buffer_cls": SequentialReplayBuffer} if cls is EnvIndependentReplayBuffer else {}
    batches = []
    for use_kernel in (True, False):
        rng = np.random.default_rng(2)
        rb = _filled(cls, rng, **extra)
        before = native.launch_count
        if not use_kernel:
            monkeypatch.setattr(native, "gather_rows", lambda *a, **k: None)
            monkeypatch.setattr(native, "gather_sequences", lambda *a, **k: None)
        batches.append(rb.sample(4, n_samples=3, **kw))
        assert (native.launch_count > before) is use_kernel
    assert batches[0].keys() == batches[1].keys()
    for k in batches[0]:
        assert batches[0][k].dtype == batches[1][k].dtype
        np.testing.assert_array_equal(batches[0][k], batches[1][k], err_msg=k)
