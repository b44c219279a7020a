"""The port's DMC adapter (``envs/dmc.py``, ``envs/dmc_variants.py``)
against the JAX package's on the CPU, with dm_control and MuJoCo.

Every check that renders runs in an interpreter of its own
(``tests/torch_dmc_checks.py``): MuJoCo's EGL renderer segfaults in a
process that has loaded TensorFlow, as every pytest worker has through
``tests/test_torch_tf_preload.py``. Bounds held, all exact: the spaces;
100 seeded steps of walker_walk and cartpole_swingup_sparse with pixels
and vectors, the same actions on both sides (every pixel, the ``state``
vector, the reward, the termination, the truncation); the variants' noise
with numpy's global generator seeded the same for each side; ``make_env``
of ``exp=dreamer_v3_dmc_walker_walk`` (action repeat 2, the ``rgb`` key,
64x64). A tiny CPU CLI dry run of that exp writes a checkpoint. Without
dm_control, building its env raises ``ModuleNotFoundError`` naming it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu_torch.config.compose import compose as port_compose
from sheeprl_tpu_torch.envs import dmc as tdmc
from sheeprl_tpu_torch.envs import factory as tfactory
from sheeprl_tpu_torch.utils.utils import dotdict

REPO = Path(__file__).resolve().parents[1]
WALKER = ["exp=dreamer_v3_dmc_walker_walk", "env.capture_video=False"]


def _jax_dmc():
    """The JAX adapter, imported inside a test: it imports dm_control at
    import, and TensorFlow segfaults when a process loads it after
    dm_control (``tests/test_torch_tf_preload.py`` loads it at collection,
    which comes later than this module's)."""
    from sheeprl_tpu.envs import dmc

    return dmc


@pytest.mark.parametrize("check", ["walker_walk", "cartpole_swingup_sparse", "variants", "pipeline", "cli_dry_run"])
def test_rendering_checks_hold_in_a_clean_interpreter(check, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", MUJOCO_GL="egl", SHEEPRL_TPU_RUNS_JSONL="")
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_dmc_checks", check, str(tmp_path)],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0 and f"DMC_CHECK_OK {check}" in proc.stdout, proc.stdout[-2000:] + proc.stderr[-4000:]


@pytest.mark.parametrize("domain, task", [("walker", "walk"), ("cartpole", "swingup_sparse")])
def test_spaces_equal_the_jax_adapters(domain, task):
    """Built without rendering: the pixel and vector spaces, the action
    spaces (normalised and the task's) and the reward range."""
    kw = {"from_pixels": True, "from_vectors": True, "height": 64, "width": 64, "seed": 3}
    jenv, tenv = _jax_dmc().DMCWrapper(domain, task, **kw), tdmc.DMCWrapper(domain, task, **kw)
    assert set(tenv.observation_space.spaces) == set(jenv.observation_space.spaces) == {"rgb", "state"}
    pairs = [(jenv.observation_space[k], tenv.observation_space[k]) for k in ("rgb", "state")]
    pairs += [(getattr(jenv, n), getattr(tenv, n)) for n in ("action_space", "_true_action_space", "state_space")]
    for want, got in pairs:
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        np.testing.assert_array_equal(got.low, want.low)
        np.testing.assert_array_equal(got.high, want.high)
    assert tenv.reward_range == jenv.reward_range


def test_vectors_only_and_the_refusal_of_neither():
    kw = {"from_pixels": False, "from_vectors": True, "seed": 3}
    jdmc = _jax_dmc()
    jenv, tenv = jdmc.DMCWrapper("cartpole", "swingup_sparse", **kw), tdmc.DMCWrapper("cartpole", "swingup_sparse", **kw)
    assert set(tenv.observation_space.spaces) == {"state"}
    jobs, tobs = jenv.reset(seed=1)[0], tenv.reset(seed=1)[0]
    np.testing.assert_array_equal(tobs["state"], jobs["state"])
    action = np.full(tenv.action_space.shape, 0.3, np.float32)
    for _ in range(10):
        jout, tout = jenv.step(action), tenv.step(action)
        np.testing.assert_array_equal(tout[0]["state"], jout[0]["state"])
        assert tout[1:4] == jout[1:4]
    for cls in (jdmc.DMCWrapper, tdmc.DMCWrapper):
        with pytest.raises(ValueError, match="must not be both False"):
            cls("cartpole", "swingup_sparse", from_pixels=False, from_vectors=False)


def test_without_dm_control_building_the_env_raises(monkeypatch):
    """No DMC env is faked: with dm_control blocked, the exp's env raises
    ``ModuleNotFoundError`` naming it."""
    monkeypatch.setitem(sys.modules, "dm_control", None)
    assert not tdmc.dmc_available()
    cfg = dotdict(port_compose("config", WALKER))
    with pytest.raises(ModuleNotFoundError, match="dm_control") as err:
        tfactory.make_env(cfg, 0, 0, None, "train")()
    assert err.value.name == "dm_control"
