"""The port's RMSProp and SGD (``sheeprl_tpu_torch/ops/optim.py``) against
the JAX package's ``rmsprop``, ``rmsprop_tf`` and ``sgd`` (optax behind
``add_decayed_weights`` and ``clip_by_global_norm``) on the CPU: five steps
of the same seeded gradients, plain, centered, with momentum, with weight
decay, clipped, with a linear schedule and all at once; the parameters and
every state tensor within ``RMS_TOL``, the state in optax's nesting both
ways, and a JAX state through a pickle checkpoint read with JAX blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu_torch.algos.dreamer_v3.convert import _nesting, optimizer_from_optax, optimizer_to_optax, rmsprop_from_optax, rmsprop_to_optax
from sheeprl_tpu_torch.ops import optim as toptim
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
RMS_TOL = 1e-6
STEPS = 5
SHAPES = {"a": (5, 3), "b": (3,), "c": (4, 4)}
CASES = {
    "plain": {},
    "centered": {"centered": True},
    "momentum": {"momentum": 0.9},
    "weight_decay": {"weight_decay": 0.1},
    "clip": {"max_grad_norm": 0.5},
    "schedule": {"schedule_steps": 8},
    "all": {"centered": True, "momentum": 0.5, "weight_decay": 0.01, "max_grad_norm": 1.0},
}


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _jax_tx(tf, kw, lr=1e-2):
    kw = dict(kw)
    steps = kw.pop("schedule_steps", 0)
    schedule = optax.linear_schedule(lr, 0.0, steps) if steps else None
    return (joptim.rmsprop_tf if tf else joptim.rmsprop)(lr=lr, eps=1e-4, schedule=schedule, **kw)


def _port_opt(tf, kw, params, lr=1e-2):
    kw = dict(kw)
    cfg = {"lr": lr, "eps": 1e-4, **{k: v for k, v in kw.items() if k not in ("max_grad_norm", "schedule_steps")}}
    return (toptim.rmsprop_tf if tf else toptim.rmsprop)(params, cfg, kw.get("max_grad_norm", 0.0), kw.get("schedule_steps", 0))


def to_tree(d):
    return {k: torch.as_tensor(v).numpy().copy() for k, v in d.items()}


def from_tree(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _run_both(tf, kw):
    params, grads = _draws()
    tx = _jax_tx(tf, kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in SHAPES]
    opt = _port_opt(tf, kw, tp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(g[k]) for k in SHAPES])
    return jax.device_get(jp), jax.device_get(state), tp, opt


@pytest.mark.parametrize("tf", [False, True], ids=["rmsprop", "rmsprop_tf"])
@pytest.mark.parametrize("case", list(CASES))
def test_rmsprop_matches_optax(case, tf):
    jp, jstate, tp, opt = _run_both(tf, CASES[case])
    for k, p in zip(SHAPES, tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=RMS_TOL, rtol=RMS_TOL, err_msg=k)
    # the state in optax's nesting, every leaf within the bound
    state = rmsprop_to_optax(opt, list(SHAPES), to_tree)
    assert _nesting(state) == _nesting(jstate)
    got, want = jax.tree.leaves(state), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=RMS_TOL, rtol=RMS_TOL)
    # and back into a fresh optimizer
    fresh = _port_opt(tf, CASES[case], [torch.zeros(s) for s in SHAPES.values()])
    optimizer_from_optax(jstate, fresh, list(SHAPES), from_tree)
    # the step count is optax state only under a schedule
    n = None if fresh.schedule_steps else -1
    for a, b in zip(fresh.state_tensors()[:n], opt.state_tensors()[:n]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=RMS_TOL, rtol=RMS_TOL)


def test_the_nesting_of_another_optimizer_is_refused():
    _, jstate, tp, _ = _run_both(False, CASES["centered"])
    plain = _port_opt(False, {}, tp)
    with pytest.raises(ValueError, match="nesting"):
        rmsprop_from_optax(jstate, plain, list(SHAPES), from_tree)


def test_build_optimizer_follows_the_config_target():
    params = [torch.nn.Parameter(torch.zeros(3))]
    cfg = {"lr": 1e-3, "eps": 1e-8, "alpha": 0.99, "momentum": 0, "centered": False, "weight_decay": 0}
    rms = toptim.build_optimizer(params, {"_target_": "sheeprl_tpu_torch.ops.optim.rmsprop", **cfg}, 0.5)
    tf = toptim.build_optimizer(params, {"_target_": "sheeprl_tpu_torch.ops.optim.rmsprop_tf", **cfg})
    assert isinstance(rms, toptim.RMSProp) and not rms.eps_in_sqrt and rms.max_grad_norm == 0.5
    assert isinstance(tf, toptim.RMSProp) and tf.eps_in_sqrt
    adam = toptim.build_optimizer(params, {"_target_": "sheeprl_tpu_torch.ops.optim.adam", "lr": 1e-3, "eps": 1e-8})
    assert isinstance(adam, toptim.Adam)
    sgd = toptim.build_optimizer(params, {"_target_": "sheeprl_tpu_torch.ops.optim.sgd", "lr": 1e-2, "momentum": 0.9, "nesterov": True}, 0.5, 8)
    assert isinstance(sgd, toptim.SGD) and (sgd.lr, sgd.momentum, sgd.nesterov, sgd.max_grad_norm, sgd.schedule_steps) == (1e-2, 0.9, True, 0.5, 8)
    with pytest.raises(NotImplementedError, match="lamb"):
        toptim.build_optimizer(params, {"_target_": "sheeprl_tpu_torch.ops.optim.lamb", "lr": 1e-2})


def test_jax_rmsprop_state_round_trips_through_a_checkpoint_without_jax(tmp_path):
    """The JAX state after five steps (centered, momentum, weight decay,
    clipping) saved by the JAX package's ``save_checkpoint``, loaded in a
    child process with JAX, flax, optax and sheeprl_tpu blocked, read into
    the port's RMSProp and written back: every leaf bit-equal, in optax's
    nesting."""
    kw = CASES["all"]
    _, jstate, _, _ = _run_both(False, kw)
    src, dst = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_save_checkpoint(src, {"opt_state": jstate})
    blocked = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
    code = f"""
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np, torch
from sheeprl_tpu_torch.algos.dreamer_v3.convert import optimizer_from_optax, optimizer_to_optax
from sheeprl_tpu_torch.ops.optim import rmsprop
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
shapes, kw, src, dst = json.loads(sys.argv[1])
opt = rmsprop([torch.zeros(s) for s in shapes.values()], {{"lr": 1e-2, "eps": 1e-4, "centered": True, "momentum": 0.5, "weight_decay": 0.01}}, 1.0)
to_tree = lambda d: {{k: v.numpy().copy() for k, v in d.items()}}
optimizer_from_optax(load_checkpoint(src)["opt_state"], opt, list(shapes), lambda t: {{k: torch.as_tensor(np.asarray(v)) for k, v in t.items()}})
save_checkpoint(dst, {{"opt_state": optimizer_to_optax(opt, list(shapes), to_tree)}})
assert all(sys.modules.get(name) is None for name in {blocked!r})
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = json.dumps([SHAPES, kw, src, dst])
    proc = subprocess.run([sys.executable, "-c", code, args], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    back = load_checkpoint(dst)["opt_state"]
    assert _nesting(back) == _nesting(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# SGD against the JAX package's ``sgd`` (optax's ``sgd`` behind
# ``add_decayed_weights`` and ``clip_by_global_norm``)
# --------------------------------------------------------------------------- #

SGD_CASES = {
    "plain": {},
    "momentum": {"momentum": 0.9},
    "nesterov": {"momentum": 0.9, "nesterov": True},
    "nesterov_without_momentum": {"nesterov": True},
    "weight_decay": {"weight_decay": 0.1},
    "clip": {"max_grad_norm": 0.5},
    "schedule": {"momentum": 0.9, "schedule_steps": 8},
    "all": {"momentum": 0.5, "nesterov": True, "weight_decay": 0.01, "max_grad_norm": 1.0, "schedule_steps": 8},
}


def _sgd_pair(kw, params, lr=1e-2):
    kw = dict(kw)
    steps = kw.pop("schedule_steps", 0)
    clip = kw.pop("max_grad_norm", 0.0)
    tx = joptim.sgd(lr=lr, max_grad_norm=clip, schedule=optax.linear_schedule(lr, 0.0, steps) if steps else None, **kw)
    return tx, toptim.sgd(params, {"lr": lr, **kw}, clip, steps)


def _run_sgd(kw):
    params, grads = _draws(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.tensor(params[k]) for k in SHAPES]
    tx, opt = _sgd_pair(kw, tp)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(g[k]) for k in SHAPES])
    return jax.device_get(jp), jax.device_get(state), tp, opt


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_sgd_matches_optax(case):
    jp, jstate, tp, opt = _run_sgd(SGD_CASES[case])
    for k, p in zip(SHAPES, tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), atol=RMS_TOL, rtol=RMS_TOL, err_msg=k)
    state = optimizer_to_optax(opt, list(SHAPES), to_tree)
    assert _nesting(state) == _nesting(jstate)
    got, want = jax.tree.leaves(state), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=RMS_TOL, rtol=RMS_TOL)
    fresh = _sgd_pair(SGD_CASES[case], [torch.zeros(s) for s in SHAPES.values()])[1]
    optimizer_from_optax(jstate, fresh, list(SHAPES), from_tree)
    n = None if fresh.schedule_steps else -1
    for a, b in zip(fresh.state_tensors()[:n], opt.state_tensors()[:n]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=RMS_TOL, rtol=RMS_TOL)


def test_sgd_composes_from_the_optim_group_and_refuses_another_nesting():
    from sheeprl_tpu_torch.config import compose

    from sheeprl_tpu.config import compose as jax_compose

    # exp=ppo sets Adam's eps, which sgd takes in neither package
    params = [torch.nn.Parameter(torch.zeros(3))]
    for fn, conf in ((lambda c: joptim.build_tx(c), jax_compose), (lambda c: toptim.build_optimizer(params, c), compose)):
        with pytest.raises(TypeError, match="unexpected keyword argument 'eps'"):
            fn(conf("config", ["exp=ppo", "optim=sgd"])["algo"]["optimizer"])
    cfg = compose("config", ["exp=ppo", "optim=sgd", "~algo.optimizer.eps", "algo.optimizer.momentum=0.9"])
    opt = toptim.build_optimizer(params, cfg["algo"]["optimizer"])
    assert isinstance(opt, toptim.SGD) and opt.momentum == 0.9 and not opt.nesterov
    _, jstate, _, _ = _run_sgd(SGD_CASES["plain"])
    with pytest.raises(ValueError, match="nesting"):
        optimizer_from_optax(jstate, opt, ["a"], from_tree)


def test_jax_sgd_state_round_trips_through_a_checkpoint_without_jax(tmp_path):
    """As for RMSProp: the JAX ``sgd`` state (momentum, Nesterov, weight
    decay, clipping, a schedule) after five steps, read into the port's SGD
    in a child process with JAX blocked and written back bit-equal."""
    _, jstate, _, _ = _run_sgd(SGD_CASES["all"])
    src, dst = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_save_checkpoint(src, {"opt_state": jstate})
    blocked = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
    code = f"""
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np, torch
from sheeprl_tpu_torch.algos.dreamer_v3.convert import optimizer_from_optax, optimizer_to_optax
from sheeprl_tpu_torch.ops.optim import sgd
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
shapes, src, dst = json.loads(sys.argv[1])
opt = sgd([torch.zeros(s) for s in shapes.values()], {{"lr": 1e-2, "momentum": 0.5, "nesterov": True, "weight_decay": 0.01}}, 1.0, 8)
to_tree = lambda d: {{k: v.numpy().copy() for k, v in d.items()}}
optimizer_from_optax(load_checkpoint(src)["opt_state"], opt, list(shapes), lambda t: {{k: torch.as_tensor(np.asarray(v)) for k, v in t.items()}})
assert int(opt.count) == 5
save_checkpoint(dst, {{"opt_state": optimizer_to_optax(opt, list(shapes), to_tree)}})
assert all(sys.modules.get(name) is None for name in {blocked!r})
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, json.dumps([SHAPES, src, dst])], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    back = load_checkpoint(dst)["opt_state"]
    assert _nesting(back) == _nesting(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
