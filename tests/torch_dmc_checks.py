"""The DMC checks that render, each run by ``tests/test_torch_dmc.py`` in
an interpreter of its own: MuJoCo's EGL renderer segfaults in a process
that has loaded TensorFlow (as every pytest worker has, through
``tests/test_torch_tf_preload.py``), and a process that renders first
crashes when it loads TensorFlow later.

``python -m tests.torch_dmc_checks <check> [<tmp dir>]`` exits 0 when the
check holds; a failed check raises. Every comparison is exact.
"""

import glob
import sys

import numpy as np

SIZE = 64
STEPS = 100
WALKER = ["exp=dreamer_v3_dmc_walker_walk", "env.capture_video=False"]


def _assert_obs_equal(want, got, where):
    assert set(got) == set(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


def _pair(jcls, tcls, domain, task):
    kw = {"from_pixels": True, "from_vectors": True, "height": SIZE, "width": SIZE, "seed": 3}
    return jcls(domain, task, **kw), tcls(domain, task, **kw)


def seeded_steps(domain, task):
    """``STEPS`` seeded steps with pixels and vectors: every pixel, the
    state vector, the reward, the ends, the discount and MuJoCo's state."""
    from sheeprl_tpu.envs import dmc as jdmc
    from sheeprl_tpu_torch.envs import dmc as tdmc

    jenv, tenv = _pair(jdmc.DMCWrapper, tdmc.DMCWrapper, domain, task)
    _assert_obs_equal(jenv.reset(seed=5)[0], tenv.reset(seed=5)[0], "reset")
    rng = np.random.default_rng(0)
    for t in range(STEPS):
        action = rng.uniform(-1, 1, tenv.action_space.shape).astype(np.float32)
        jobs, jrew, jterm, jtrunc, jinfo = jenv.step(action)
        tobs, trew, tterm, ttrunc, tinfo = tenv.step(action)
        _assert_obs_equal(jobs, tobs, f"step {t}")
        assert (trew, tterm, ttrunc, tinfo["discount"]) == (jrew, jterm, jtrunc, jinfo["discount"]), t
        np.testing.assert_array_equal(tinfo["internal_state"], jinfo["internal_state"])
    np.testing.assert_array_equal(tenv.current_state, jenv.current_state)
    np.testing.assert_array_equal(tenv.render(camera_id=1), jenv.render(camera_id=1))


def variants():
    """Both variants, numpy's global generator seeded the same before each
    side's reset and step."""
    from sheeprl_tpu.envs import dmc_variants as jvariants
    from sheeprl_tpu_torch.envs import dmc_variants as tvariants

    for name in ("DMC64Wrapper", "DMCExtendedWrapper"):
        jenv, tenv = _pair(getattr(jvariants, name), getattr(tvariants, name), "cartpole", "swingup_sparse")
        assert set(tenv.observation_space.spaces) == set(jenv.observation_space.spaces), name
        rng = np.random.default_rng(1)
        for t in range(5):
            action = rng.uniform(-1, 1, tenv.action_space.shape).astype(np.float32)
            np.random.seed(100 + t)
            jout = jenv.reset(seed=2) if t == 0 else jenv.step(action)
            np.random.seed(100 + t)
            tout = tenv.reset(seed=2) if t == 0 else tenv.step(action)
            _assert_obs_equal(jout[0], tout[0], f"{name} step {t}")


def pipeline():
    """``make_env`` of ``exp=dreamer_v3_dmc_walker_walk`` (action repeat 2,
    the ``rgb`` key, 64x64) in both packages, free-running."""
    from sheeprl_tpu.config.compose import compose as jax_compose
    from sheeprl_tpu.envs import factory as jfactory
    from sheeprl_tpu_torch.config.compose import compose as port_compose
    from sheeprl_tpu_torch.envs import factory as tfactory
    from sheeprl_tpu_torch.utils.utils import dotdict

    jcfg, tcfg = dotdict(jax_compose("config", WALKER)), dotdict(port_compose("config", WALKER))
    assert tcfg.env.action_repeat == jcfg.env.action_repeat == 2
    jenv, tenv = jfactory.make_env(jcfg, 3, 0, None, "train")(), tfactory.make_env(tcfg, 3, 0, None, "train")()
    assert tenv.observation_space["rgb"].shape == jenv.observation_space["rgb"].shape == (64, 64, 3)
    _assert_obs_equal(jenv.reset(seed=0)[0], tenv.reset(seed=0)[0], "reset")
    rng = np.random.default_rng(2)
    for t in range(20):
        action = rng.uniform(-1, 1, tenv.action_space.shape).astype(np.float32)
        jout, tout = jenv.step(action), tenv.step(action)
        _assert_obs_equal(jout[0], tout[0], f"step {t}")
        assert tout[1:4] == jout[1:4], t


def cli_dry_run(tmp):
    """A CPU CLI dry run of the walker exp at tiny widths writes a
    checkpoint (no TensorBoard logger: it would load TensorFlow). The exp
    sets ``fabric.accelerator: tpu`` and bf16-mixed, so the CPU's fabric
    is given key by key."""
    from sheeprl_tpu_torch import cli
    from tests.test_torch_cli import TINY

    tiny = [a for a in TINY if not a.startswith(("exp=", "env=", "env.id=", "algo.cnn_keys", "algo.mlp_keys"))]
    cpu = ["fabric.accelerator=cpu", "fabric.precision=32-true", "env.backend=sync", "metric.log_level=0", "algo.run_test=False"]
    cli.run(WALKER + tiny + cpu + [f"log_base_dir={tmp}", "run_name=walker"])
    assert glob.glob(f"{tmp}/dreamer_v3/walker_walk/walker/version_0/checkpoint/*.ckpt"), tmp


CHECKS = {
    "walker_walk": lambda: seeded_steps("walker", "walk"),
    "cartpole_swingup_sparse": lambda: seeded_steps("cartpole", "swingup_sparse"),
    "variants": variants,
    "pipeline": pipeline,
    "cli_dry_run": lambda: cli_dry_run(sys.argv[2]),
}

if __name__ == "__main__":
    CHECKS[sys.argv[1]]()
    print(f"DMC_CHECK_OK {sys.argv[1]}")
