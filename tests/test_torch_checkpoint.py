"""Checkpoints in the JAX layout: the port reads the JAX package's pickle
checkpoints (with JAX, flax and optax blocked), converts them exactly, takes
the next gradient step as the JAX package does, and writes checkpoints of
the same layout that round-trip exactly.

The JAX train state comes from one JAX ``local_train`` step at the tiny
sizes of ``tests/test_torch_dv3_train.py`` (dense 8, recurrent 8, stoch
4x4, 16x16 pixels, T=4, B=2, horizon 3), saved by
``sheeprl_tpu.utils.checkpoint.save_checkpoint`` in ``ckpt_state_fn``'s
layout. Conversions and round trips are exact (bitwise); the step from the
checkpoint holds the JAX step at ``test_torch_dv3_train.py``'s bounds:
1e-5 on the losses, 1e-4 on the gradients and gradient norms, and the
updated params within 2 lr + 1e-6 (1e-6 where |g| > 1e-3).
"""

import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jdv3
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops.optim import adam as j_adam
from sheeprl_tpu.resilience.manifest import tree_digest as j_tree_digest
from sheeprl_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    _nesting,
    actor_from_flax,
    actor_to_flax,
    adam_to_optax,
    critic_from_flax,
    critic_to_flax,
    world_model_from_flax,
    world_model_to_flax,
)
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.ops.optim import Adam
from sheeprl_tpu_torch.resilience.manifest import tree_digest
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_dv3_train import (  # noqa: F401  (deterministic is a fixture)
    GRAD_TOL,
    TOL,
    _jax_tx,
    _recording,
    batch,
    close,
    deterministic,
    jax_modules,
    obs_space,
    t,
    tiny_cfg,
)

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
MODELS = ("world_model", "actor", "critic")
CASES = [((3,), False, "dummy_discrete"), ((2,), True, "dummy_continuous")]


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dicts, tuples and records."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_trees_equal(got, want):
    """Same containers, record classes by name, keys and bitwise-equal
    leaves."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def jax_local_train(cfg, modules, actions_dim, is_continuous):
    """The JAX package's jitted one-step ``local_train`` with recording
    optimizers (their states carry each step's gradients). A fresh trace:
    it samples with whatever sampler is patched in when it is made."""
    jwm, jact, jcrit = modules
    algo = cfg["algo"]
    txs = [_recording(_jax_tx(algo[k]["optimizer"], algo[k]["clip_gradients"])) for k in MODELS]
    fabric = types.SimpleNamespace(data_axis="data", world_size=1, model_axis=None)
    local_train, _ = jdv3.make_train_step(fabric, jwm, jact, jcrit, *txs, dotdict(cfg), is_continuous, actions_dim)
    return jax.jit(local_train), txs


def jax_ckpt_state(params, opts, moments):
    """The train state in ``ckpt_state_fn``'s layout (JAX main :742-763)."""
    wp, ap, cp, tp = params
    key = jax.random.PRNGKey(3)
    return {
        "world_model": wp,
        "actor": ap,
        "critic": cp,
        "target_critic": tp,
        "world_optimizer": opts[0][0],
        "actor_optimizer": opts[1][0],
        "critic_optimizer": opts[2][0],
        "moments": {"low": np.asarray(moments.low), "high": np.asarray(moments.high)},
        "ratio": {"_ratio": 1.0, "_prev": 40.0, "_pretrain_steps": 0},
        "update": 20,
        "batch_size": 2,
        "last_log": 32,
        "last_checkpoint": 40,
        "rng_key": key,
        "player_rng_key": jax.random.fold_in(key, 1),
    }


def port_models(cfg, actions_dim, is_continuous):
    """Seeded port modules and optimizers (to be overwritten by a load)."""
    wm, actor, _ = tagent.build_agent(actions_dim, is_continuous, cfg, obs_space(("rgb",), ("state",)), device="cpu")
    critic, target = tagent.build_critic(cfg, wm.latent_state_size, device="cpu")
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    return wm, actor, critic, target, opts, tm.init_moments()


@pytest.fixture(scope="module", params=CASES, ids=["discrete", "continuous"])
def jax_ckpt(request, tmp_path_factory):
    """A JAX checkpoint after one JAX step, with what made it."""
    actions_dim, is_continuous, env = request.param
    cfg = tiny_cfg(env=env)
    jwm, wp, jact, ap, jcrit, cp, tp = jax_modules(cfg, obs_space(("rgb",), ("state",)), actions_dim, is_continuous)
    modules = (jwm, jact, jcrit)
    local_train, txs = jax_local_train(cfg, modules, actions_dim, is_continuous)
    d = {k: jnp.asarray(v) for k, v in batch(("rgb",), ("state",), actions_dim, is_continuous, seed=21).items()}
    opts = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    out = local_train(wp, ap, cp, tp, *opts, jm.init_moments(), d, jax.random.PRNGKey(0))
    params, opts, moments = (*out[:3], tp), out[3:6], out[6]
    state = jax_ckpt_state(params, opts, moments)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt_40_0.ckpt")
    j_save_checkpoint(path, state)
    return types.SimpleNamespace(
        cfg=cfg, actions_dim=actions_dim, is_continuous=is_continuous, path=path,
        host=jax.tree.map(np.asarray, state), modules=modules, params=params, opts=opts, moments=moments,
    )


def test_jax_checkpoint_loads_and_converts_exactly_without_jax(jax_ckpt, tmp_path):
    """A child process with JAX, jaxlib, flax, optax and sheeprl_tpu blocked
    loads the JAX checkpoint, loads it into the port's modules, optimizers
    and Moments, and writes them back in the JAX layout: every param, Adam
    count and moment, Moments value, the Ratio and the counters come back
    bitwise equal, in optax's nesting."""
    out = str(tmp_path / "ckpt_40_0.ckpt")
    args = json.dumps([jax_ckpt.cfg, list(jax_ckpt.actions_dim), jax_ckpt.is_continuous, jax_ckpt.path, out])
    code = f"""
import json, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from sheeprl_tpu_torch.algos.dreamer_v3 import agent, dreamer_v3
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops.math import init_moments
from sheeprl_tpu_torch.utils.checkpoint import EmptyState, ScaleByAdamState, load_checkpoint, save_checkpoint
cfg, actions_dim, is_continuous, src, dst = json.loads(sys.argv[1])
state = load_checkpoint(src)
assert isinstance(state["world_optimizer"][0], EmptyState)  # clip > 0: (clip, (adam, lr))
assert isinstance(state["world_optimizer"][1][0], ScaleByAdamState)
space = spaces.Dict({{"rgb": spaces.Box(0, 255, (16, 16, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)}})
wm, actor, _ = agent.build_agent(tuple(actions_dim), is_continuous, cfg, space, device="cpu")
critic, target = agent.build_critic(cfg, wm.latent_state_size, device="cpu")
opts = dreamer_v3.build_optimizers(cfg, wm, actor, critic)
moments = init_moments()
dreamer_v3.load_checkpoint_state(state, wm, actor, critic, target, opts, moments)
keep = {{k: state[k] for k in ("ratio", "update", "batch_size", "last_log", "last_checkpoint")}}
save_checkpoint(dst, {{**dreamer_v3.checkpoint_state(wm, actor, critic, target, opts, moments), **keep}})
assert all(sys.modules.get(name) is None for name in {BLOCKED!r})
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    back = load_checkpoint(out)
    want = jax_ckpt.host
    for key in ("world_model", "actor", "critic", "target_critic", "moments"):
        assert_trees_equal(back[key], want[key])
    for key in ("world_optimizer", "actor_optimizer", "critic_optimizer"):
        assert _nesting(back[key]) == _nesting(want[key])
        assert_trees_equal(back[key], want[key])
    for key in ("ratio", "update", "batch_size", "last_log", "last_checkpoint"):
        assert back[key] == want[key]


@pytest.mark.parametrize("clip, weight_decay", [(100.0, 0.0), (0.0, 0.0), (1.0, 0.01)])
def test_optimizer_state_has_optax_nesting(clip, weight_decay, tmp_path):
    """optax's chain nesting for clip > 0, clip = 0 and adamw, pinned on the
    JAX tx itself: the port writes the same records in the same tuples, and
    loads the JAX state back into its Adam."""
    cfg = tiny_cfg()
    wm, actor, critic, *_ = port_models(cfg, (3,), False)
    opt = Adam(list(critic.parameters()), lr=1e-3, weight_decay=weight_decay, max_grad_norm=clip)
    names = [n for n, _ in critic.named_parameters()]
    jax_state = j_adam(1e-3, weight_decay=weight_decay, max_grad_norm=clip).init(critic_to_flax(critic.state_dict()))
    path = str(tmp_path / "opt.ckpt")
    j_save_checkpoint(path, {"opt": jax_state})
    loaded = load_checkpoint(path)["opt"]
    mine = adam_to_optax(opt, names, critic_to_flax)
    assert _nesting(mine) == _nesting(loaded) == _nesting(jax_state)
    assert_trees_equal(mine, loaded)


def test_step_from_a_jax_checkpoint_matches_the_jax_step(jax_ckpt, deterministic):
    """The port, resumed from the JAX checkpoint, takes the next gradient
    step as the JAX package does from the same state: the 13 metrics, the
    three gradients, the updated params, Moments and Adam's count."""
    cfg, actions_dim, is_continuous = jax_ckpt.cfg, jax_ckpt.actions_dim, jax_ckpt.is_continuous
    d = batch(("rgb",), ("state",), actions_dim, is_continuous, seed=22)
    local_train, _ = jax_local_train(cfg, jax_ckpt.modules, actions_dim, is_continuous)
    jd_ = {k: jnp.asarray(v) for k, v in d.items()}
    out = local_train(*jax_ckpt.params, *jax_ckpt.opts, jax_ckpt.moments, jd_, jax.random.PRNGKey(1))
    j_new = dict(zip(MODELS, out[:3]))
    j_opts, j_moments, j_metrics = out[3:6], out[6], out[7]
    j_grads = {k: o[1] for k, o in zip(MODELS, j_opts)}

    wm, actor, critic, target, opts, moments = port_models(cfg, actions_dim, is_continuous)
    tdv3.load_checkpoint_state(load_checkpoint(jax_ckpt.path), wm, actor, critic, target, opts, moments)
    step = tdv3.make_train_step(wm, actor, critic, target, *opts, cfg, is_continuous)
    grads = {}
    _, metrics = step(moments, {k: t(v) for k, v in d.items()}, None, grads)
    close(metrics[:10], np.asarray(j_metrics)[:10], TOL)
    close(metrics[10:], np.asarray(j_metrics)[10:], GRAD_TOL)
    close(moments.low, j_moments.low)
    close(moments.high, j_moments.high)
    from_flax = {"world_model": world_model_from_flax, "actor": actor_from_flax, "critic": critic_from_flax}
    modules = dict(zip(MODELS, (wm, actor, critic)))
    for name, module in modules.items():
        want = from_flax[name](j_grads[name])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        for k in want:
            close(got[k], want[k], GRAD_TOL, f"{name} grad {k}")
        new, lr = from_flax[name](j_new[name]), cfg["algo"][name]["optimizer"]["lr"]
        sd = module.state_dict()
        for k in new:
            diff = (sd[k] - new[k]).abs()
            assert float(diff.max()) <= 2 * lr + 1e-6, f"{name} param {k}"
            big = want[k].abs() > 1e-3
            if big.any():
                assert float(diff[big].max()) <= 1e-6, f"{name} param {k} (|g| > 1e-3)"
    assert [int(o.count) for o in opts] == [2, 2, 2]


def test_port_checkpoint_round_trips_exactly(tmp_path):
    """checkpoint_state -> save -> load -> load_checkpoint_state into other
    modules -> checkpoint_state gives the same trees bitwise; the manifest
    digest of the layout is the JAX package's."""
    cfg = tiny_cfg(env="dummy_continuous")
    wm, actor, critic, target, opts, moments = port_models(cfg, (2,), True)
    step = tdv3.make_train_step(wm, actor, critic, target, *opts, cfg, True)
    d = batch(("rgb",), ("state",), (2,), True, seed=23)
    step(moments, {k: t(v) for k, v in d.items()}, torch.Generator().manual_seed(0))
    state = tdv3.checkpoint_state(wm, actor, critic, target, opts, moments)
    path = str(tmp_path / "ckpt_8_0.ckpt")
    save_checkpoint(path, state)
    other = port_models(tiny_cfg(env="dummy_continuous", seed=7), (2,), True)
    tdv3.load_checkpoint_state(load_checkpoint(path), *other)
    again = tdv3.checkpoint_state(*other)
    for key in state:
        assert_trees_equal(again[key], state[key])
    assert int(other[4][0].count) == 1
    # the structural digest the manifest carries, as the JAX package computes it
    jax_view = jax.tree.map(np.asarray, {**state, "update": 3, "ratio": {"_prev": None, "_ratio": 1.0}})
    assert tree_digest(jax_view) == j_tree_digest(jax_view)
    # and the converters invert each other on the JAX param trees
    for fwd, back, tree in (
        (world_model_from_flax, world_model_to_flax, state["world_model"]),
        (actor_from_flax, actor_to_flax, state["actor"]),
        (critic_from_flax, critic_to_flax, state["critic"]),
    ):
        assert_trees_equal(back(fwd(tree)), tree)


def test_unpickler_refuses_classes_outside_its_allow_list(tmp_path):
    """A class off the allow-list raises with its dotted name; the JAX
    package's replay buffer loads as the port's (``tests/test_torch_dv3_gaps.py``
    holds its windows); the port's own buffer loads."""
    from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"x": types.SimpleNamespace(a=1)}, f)
    with pytest.raises(pickle.UnpicklingError, match="types.SimpleNamespace"):
        load_checkpoint(path)
    with open(path, "wb") as f:
        pickle.dump({"rb": JaxReplayBuffer(4, n_envs=1)}, f)
    loaded = load_checkpoint(path)["rb"]
    assert type(loaded) is ReplayBuffer and loaded.buffer_size == 4 and loaded.empty
    rb = EnvIndependentReplayBuffer(8, n_envs=2, obs_keys=("state",), buffer_cls=SequentialReplayBuffer, seed=0)
    rb.add({"state": np.ones((3, 2, 5), np.float32), "truncated": np.zeros((3, 2, 1), np.float32)})
    save_checkpoint(path, {"rb": rb, "update": np.int64(3)})
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back["rb"].buffer[1].buffer["state"], rb.buffer[1].buffer["state"])
    assert back["update"] == 3
    with pytest.raises(ValueError, match="orbax"):
        save_checkpoint(path, {}, backend="orbax")
