"""The port's ``MemmapArray`` and memmapped host replay
(sheeprl_tpu_torch/data/{memmap,buffers}.py) against the JAX package's:
ownership, pickling and unlinking behave the same, and a memmapped buffer
samples what the in-RAM one samples for the same seed."""

import gc
import pickle

import numpy as np
import pytest

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.data.memmap import MemmapArray as JaxMemmapArray
from sheeprl_tpu_torch.data import buffers as tb
from sheeprl_tpu_torch.data.memmap import MemmapArray


def _behaviour(cls, tmp_path, dtype):
    """What one implementation does, as a list of observations."""
    seen = []
    data = np.arange(12, dtype=dtype).reshape(3, 4)
    owner = cls.from_array(data, filename=tmp_path / "a.memmap")
    seen.append((owner.has_ownership, owner.shape, str(owner.dtype), np.asarray(owner).tolist()))
    # pickled: no ownership, maps the same file again on first use
    copy = pickle.loads(pickle.dumps(owner))
    seen.append((copy.has_ownership, np.asarray(copy).tolist()))
    owner[0, 0] = 100
    seen.append(float(copy[0, 0]))
    del copy
    gc.collect()
    seen.append((tmp_path / "a.memmap").exists())
    # from_array over the owner's own file moves the ownership
    heir = cls.from_array(owner, filename=tmp_path / "a.memmap")
    seen.append((owner.has_ownership, heir.has_ownership, float(heir[0, 0])))
    del owner
    gc.collect()
    seen.append((tmp_path / "a.memmap").exists())
    del heir
    gc.collect()
    seen.append((tmp_path / "a.memmap").exists())
    # a copy into another file leaves the source its file
    src = cls.from_array(data, filename=tmp_path / "b.memmap")
    other = cls.from_array(src, filename=tmp_path / "c.memmap")
    seen.append((src.has_ownership, other.has_ownership, np.asarray(other).tolist()))
    with pytest.raises(ValueError):
        cls((2,), mode="bogus", filename=tmp_path / "d.memmap")
    for bad in (np.zeros((2, 2), dtype), [1, 2]):
        with pytest.raises(ValueError):
            src.array = bad
    return seen


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_memmap_array_behaves_as_the_jax_one(tmp_path, dtype):
    got = _behaviour(MemmapArray, tmp_path / "port", dtype)
    want = _behaviour(JaxMemmapArray, tmp_path / "jax", dtype)
    assert got == want
    assert want[3] is True and want[5] is True and want[6] is False


def _fill(rb, seed=3, steps=13, n_envs=2):
    rng = np.random.default_rng(seed)
    for i in range(steps):
        rb.add(
            {
                "rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 3), dtype=np.uint8),
                "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32),
            }
        )
        if i % 4 == 2:
            rb.add({"rgb": rng.integers(0, 256, (1, 1, 4, 4, 3), dtype=np.uint8), "rewards": np.ones((1, 1, 1), np.float32)}, [1])
    return rb


def _buffer(mod, memmap, tmp_path, name):
    kwargs = dict(memmap=True, memmap_dir=tmp_path / name) if memmap else {}
    return mod.EnvIndependentReplayBuffer(
        8, n_envs=2, obs_keys=("rgb",), buffer_cls=mod.SequentialReplayBuffer, seed=5, **kwargs
    )


@pytest.mark.parametrize("n_samples", [1, 3])
def test_memmapped_buffer_samples_what_the_in_ram_one_samples(tmp_path, n_samples):
    mm = _fill(_buffer(tb, True, tmp_path, "port"))
    ram = _fill(_buffer(tb, False, tmp_path, "ram"))
    jmm = _fill(_buffer(jb, True, tmp_path, "jax"))
    assert all(mm.is_memmap) and not any(ram.is_memmap)
    assert sorted(p.name for p in (tmp_path / "port" / "env_0").iterdir()) == ["rewards.memmap", "rgb.memmap"]
    for _ in range(3):
        got = mm.sample(3, sequence_length=4, n_samples=n_samples)
        want = ram.sample(3, sequence_length=4, n_samples=n_samples)
        jwant = jmm.sample(3, sequence_length=4, n_samples=n_samples)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], jwant[k])


def test_a_pickled_memmapped_buffer_holds_its_data(tmp_path):
    """The port's buffer pickles the memmap files' contents, so a checkpoint
    outlives the run whose files it came from."""
    mm = _fill(_buffer(tb, True, tmp_path, "port"))
    want = {k: np.array(v) for k, v in mm.buffer[1].buffer.items()}
    blob = pickle.dumps(mm)
    del mm
    gc.collect()
    assert not (tmp_path / "port" / "env_1" / "rgb.memmap").exists()
    restored = pickle.loads(blob)
    assert not any(restored.is_memmap)
    for k, v in want.items():
        np.testing.assert_array_equal(restored.buffer[1].buffer[k], v)
    restored.to_memmap(tmp_path / "again")
    assert all(restored.is_memmap) and (tmp_path / "again" / "env_1" / "rgb.memmap").exists()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(restored.buffer[1].buffer[k]), v)
