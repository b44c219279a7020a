"""Recurrent PPO in the port against the JAX package on the CPU: the LSTM
cell against flax's ``OptimizedLSTMCell``, the agent (``apply``, sampling,
``evaluate_actions`` and ``evaluate_actions_resettable``) at fp32 and
bf16-mixed, the weight conversion, ``build_sequences`` bit for bit, the
sequence update (episode chunks and fixed windows) against the JAX
``local_train`` with its permutations injected, the fused recurrent
superstep against the port's host loop, and ``python -m sheeprl_tpu_torch
exp=ppo_recurrent`` end to end: the dummy envs, checkpoints, resumes (the
port's and the JAX package's), ``cli_eval``, a CLI dry run and the fused
gate's fallbacks.

Weights come from the JAX init, shifted by seeded noise, carried across
with ``convert``; inputs are numpy draws from a seed.
"""

import glob
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent import agent as jagent
from sheeprl_tpu.algos.ppo_recurrent import ppo_recurrent as jrppo
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.convert import optimizer_from_optax
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as tagent
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as trppo
from sheeprl_tpu_torch.algos.ppo_recurrent.convert import agent_from_flax, agent_to_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.jittable import get_jittable_env
from sheeprl_tpu_torch.models.blocks import LSTMCell
from sheeprl_tpu_torch.ops.math import gae
from sheeprl_tpu_torch.ops.optim import build_optimizer
from sheeprl_tpu_torch.ops.rollout_scan import fixed_windows, init_recurrent_env_carry, make_recurrent_onpolicy_superstep_fn
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.prealloc import RolloutStore
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_precision import ENTRY_TOL, EPS, STEP_TOL
from tests.test_torch_rollout_scan import TwinVectorEnv

CELL_TOL = 1e-6
FWD_TOL = 1e-5
UPDATE_TOL = 1e-5
ROLLOUT_TOL = 1e-6
L, N = 4, 6  # sequence length, sequences

# (actions_dim, is_continuous, cnn_keys, pre/post rnn MLPs)
AGENTS = {
    "discrete": ((3,), False, (), False),
    "multi_discrete_mlps": ((3, 2), False, (), True),
    "continuous": ((2,), True, (), False),
    "nature_cnn": ((4,), False, ("rgb",), False),
}


def _cfg(precision="32-true", cnn_keys=(), rnn_mlps=False, **algo):
    mlp = lambda: {"apply": rnn_mlps, "dense_units": 8, "layer_norm": True}  # noqa: E731
    base = {
        "seed": 3,
        "fabric": {"precision": precision},
        "algo": {
            "cnn_keys": {"encoder": list(cnn_keys)},
            "mlp_keys": {"encoder": ["state"]},
            "encoder": {"cnn_features_dim": 16, "mlp_features_dim": 8, "dense_units": 8, "mlp_layers": 1},
            "rnn": {"lstm": {"hidden_size": 8}, "pre_rnn_mlp": mlp(), "post_rnn_mlp": mlp()},
            "actor": {"dense_units": 8, "mlp_layers": 1},
            "critic": {"dense_units": 8, "mlp_layers": 1},
            "dense_act": "relu",
            "layer_norm": True,
            "update_epochs": 2,
            "per_rank_num_batches": 2,
            "vf_coef": 0.2,
            "clip_vloss": True,
            "normalize_advantages": True,
            "loss_reduction": "mean",
            "reset_recurrent_state_on_done": True,
            "optimizer": {"_target_": "sheeprl_tpu_torch.ops.optim.adam", "lr": 1e-3, "eps": 1e-4, "betas": [0.9, 0.999], "weight_decay": 1e-2},
            "max_grad_norm": 0.5,
        },
    }
    base["algo"].update(algo)
    return base


def _space(cnn_keys):
    d = {k: spaces.Box(0, 255, (64, 64, 3), np.uint8) for k in cnn_keys}
    d["state"] = spaces.Box(-np.inf, np.inf, (5,), np.float32)
    return spaces.Dict(d)


def _pair(kind, precision="32-true", seed=0):
    actions_dim, cont, cnn_keys, mlps = AGENTS[kind]
    cfg = _cfg(precision, cnn_keys, mlps)
    jfab = JaxFabric(devices=1, precision=precision, accelerator="cpu")
    jag, params = jagent.build_agent(jfab, actions_dim, cont, jdotdict(cfg), _space(cnn_keys))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), jax.device_get(params))
    tag, _ = tagent.build_agent(actions_dim, cont, cfg, _space(cnn_keys), agent_from_flax(params), device="cpu")
    return jag, params, tag, cfg


def _actions(actions_dim, cont, shape, rng):
    if cont:
        return rng.standard_normal((*shape, sum(actions_dim))).astype(np.float32)
    return np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, shape)] for d in actions_dim], -1)


def _batch(kind, seed=1):
    """``[L, N]`` observations, previous and stored actions, dones, and the
    initial states, from a seed."""
    actions_dim, cont, cnn_keys, _ = AGENTS[kind]
    rng = np.random.default_rng(seed)
    obs = {k: rng.integers(0, 256, (L, N, 64, 64, 3)).astype(np.uint8) for k in cnn_keys}
    obs["state"] = rng.standard_normal((L, N, 5)).astype(np.float32)
    return {
        "obs": obs,
        "prev_actions": _actions(actions_dim, cont, (L, N), rng),
        "actions": _actions(actions_dim, cont, (L, N), rng),
        "dones": (rng.random((L, N, 1)) < 0.3).astype(np.float32),
        "hx": 0.5 * rng.standard_normal((N, 8)).astype(np.float32),
        "cx": 0.5 * rng.standard_normal((N, 8)).astype(np.float32),
    }


def t(a):
    return torch.as_tensor(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1.0))


# --------------------------------------------------------------------------- #
# the LSTM cell and the agent
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
def test_lstm_cell_matches_flax(precision):
    """Eight steps of flax's ``OptimizedLSTMCell`` and the port's cell from
    the same weights (biases shifted off zero) and inputs, the carry in the
    compute dtype throughout: within ``CELL_TOL`` at fp32, ``STEP_TOL``
    relative to max(|x|, 1) at bf16."""
    jdt, tdt = (jnp.float32, torch.float32) if precision == "32-true" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(0)
    b, i, h = 5, 7, 6
    xs = rng.standard_normal((8, b, i)).astype(np.float32)
    c0, h0 = rng.standard_normal((2, b, h)).astype(np.float32)
    cell = fnn.OptimizedLSTMCell(h, dtype=jdt, param_dtype=jnp.float32)
    params = jax.device_get(cell.init(jax.random.PRNGKey(0), (j(c0), j(h0)), j(xs[0])))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    port = LSTMCell(i, h, tdt)
    sd = agent_from_flax({"params": {"ScanOptimizedLSTMCell_0": params}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    jc, jh = j(c0).astype(jdt), j(h0).astype(jdt)
    tc, th = t(c0).to(tdt), t(h0).to(tdt)
    for x in xs:
        (jc, jh), _ = cell.apply({"params": params}, (jc, jh), j(x).astype(jdt))
        with torch.no_grad():
            (tc, th), _ = port((tc, th), t(x))
        assert tc.dtype == th.dtype == tdt
        for got, want in ((tc, jc), (th, jh)):
            if precision == "32-true":
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CELL_TOL, rtol=CELL_TOL)
            else:
                assert _rel(got, want) <= STEP_TOL, _rel(got, want) / EPS


def _jax_obs(batch, sl=slice(None)):
    return {k: j(v[sl]) for k, v in batch["obs"].items()}


def _port_obs(batch, sl=slice(None)):
    return {k: t(v[sl]) for k, v in batch["obs"].items()}


@pytest.mark.parametrize("kind", list(AGENTS))
def test_agent_matches_jax(kind):
    jag, params, tag, _ = _pair(kind)
    bt = _batch(kind)
    args_j = (j(bt["prev_actions"]), j(bt["hx"]), j(bt["cx"]))
    args_t = (t(bt["prev_actions"]), t(bt["hx"]), t(bt["cx"]))
    j_heads, j_values, (j_hx, j_cx) = jag.apply(params, _jax_obs(bt), *args_j)
    with torch.no_grad():
        t_heads, t_values, (t_hx, t_cx) = tag(_port_obs(bt), *args_t)
        t_eval = tagent.evaluate_actions(tag, _port_obs(bt), *args_t, t(bt["actions"]))
        t_reset = tagent.evaluate_actions_resettable(tag, _port_obs(bt), *args_t, t(bt["actions"]), t(bt["dones"]))
        t_greedy = tagent.sample_actions(tag, _port_obs(bt, slice(0, 1)), args_t[0][:1], args_t[1], args_t[2], greedy=True)
    pairs = list(zip(t_heads, j_heads)) + [(t_values, j_values), (t_hx, j_hx), (t_cx, j_cx)]
    pairs += zip(t_eval, jagent.evaluate_actions(jag, params, _jax_obs(bt), *args_j, j(bt["actions"])))
    pairs += zip(t_reset, jagent.evaluate_actions_resettable(jag, params, _jax_obs(bt), *args_j, j(bt["actions"]), j(bt["dones"])))
    j_greedy = jagent.sample_actions(jag, params, _jax_obs(bt, slice(0, 1)), args_j[0][:1], args_j[1], args_j[2], jax.random.PRNGKey(0), greedy=True)
    pairs += zip(t_greedy, j_greedy)
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("kind", ["discrete", "multi_discrete_mlps"])
def test_agent_matches_jax_at_bf16_mixed(kind):
    """The LSTM's carry stays bf16 over the sequence on both sides (and
    over the resets of the resettable path): outputs relative to max(|JAX|,
    1) within ``ENTRY_TOL``, the bound of ``tests/test_torch_precision.py``."""
    jag, params, tag, _ = _pair(kind, precision="bf16-mixed")
    assert tag.lstm.compute_dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in tag.parameters())
    bt = _batch(kind)
    args_j = (j(bt["prev_actions"]), j(bt["hx"]), j(bt["cx"]))
    args_t = (t(bt["prev_actions"]), t(bt["hx"]), t(bt["cx"]))
    j_out = jagent.evaluate_actions(jag, params, _jax_obs(bt), *args_j, j(bt["actions"]))
    j_reset = jagent.evaluate_actions_resettable(jag, params, _jax_obs(bt), *args_j, j(bt["actions"]), j(bt["dones"]))
    _, _, j_state = jag.apply(params, _jax_obs(bt), *args_j)
    with torch.no_grad():
        t_out = tagent.evaluate_actions(tag, _port_obs(bt), *args_t, t(bt["actions"]))
        t_reset = tagent.evaluate_actions_resettable(tag, _port_obs(bt), *args_t, t(bt["actions"]), t(bt["dones"]))
        _, _, t_state = tag(_port_obs(bt), *args_t)
    for got, want in [*zip(t_out, j_out), *zip(t_reset, j_reset), *zip(t_state, j_state)]:
        assert got.dtype == torch.float32
        assert _rel(got, want) <= ENTRY_TOL, _rel(got, want) / EPS


def test_bf16_true_casts_the_lstm_too():
    _, _, tag, _ = _pair("discrete", precision="bf16-true")
    assert all(p.dtype == torch.bfloat16 for p in tag.parameters())
    assert tag.lstm.input_kernel.dtype == torch.bfloat16


def test_convert_round_trips():
    _, params, tag, _ = _pair("nature_cnn")
    back = agent_to_flax(tag.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(params))


# --------------------------------------------------------------------------- #
# sequences and the update
# --------------------------------------------------------------------------- #


def _rollout_np(seed, steps=12, envs=3, p_done=0.2):
    rng = np.random.default_rng(seed)
    data = {
        "state": rng.standard_normal((steps, envs, 5)).astype(np.float32),
        "dones": (rng.random((steps, envs, 1)) < p_done).astype(np.float32),
        "actions": _actions((3,), False, (steps, envs), rng),
        "prev_actions": _actions((3,), False, (steps, envs), rng),
        "prev_hx": rng.standard_normal((steps, envs, 8)).astype(np.float32),
        "prev_cx": rng.standard_normal((steps, envs, 8)).astype(np.float32),
    }
    for k in ("logprobs", "values", "returns", "advantages"):
        data[k] = rng.standard_normal((steps, envs, 1)).astype(np.float32)
    data["logprobs"] = -np.abs(data["logprobs"]) - 0.5
    return data


TRAIN_KEYS = ["state", "actions", "logprobs", "values", "returns", "advantages", "prev_actions"]


@pytest.mark.parametrize("seed, seq_len, pad", [(0, 4, 2), (1, 5, 3), (2, 16, 4), (3, 1, 8)])
def test_build_sequences_is_bit_equal_to_jax(seed, seq_len, pad):
    data = _rollout_np(seed)
    want = jrppo.build_sequences(data, TRAIN_KEYS, seq_len, 3, pad)
    got = trppo.build_sequences(data, TRAIN_KEYS, seq_len, 3, pad)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_perms(key, epochs, n):
    perms = []
    for _ in range(epochs):
        key, perm_key = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(perm_key, n)))
    return np.stack(perms)


@pytest.mark.parametrize("kind, windows", [("discrete", False), ("continuous", False), ("multi_discrete_mlps", True)])
def test_update_matches_jax_local_train(kind, windows):
    """Two epochs of two minibatches of sequences with normalised masked
    advantages, clipped values, AdamW behind clipping: episode chunks from
    ``build_sequences`` (``windows=False``), or fixed windows that cross
    dones through ``evaluate_actions_resettable``. Every parameter and the
    metrics within ``UPDATE_TOL``."""
    jag, params, tag, cfg = _pair(kind)
    actions_dim, cont, _, _ = AGENTS[kind]
    data = _rollout_np(7, steps=8, envs=2)
    rng = np.random.default_rng(8)
    data["actions"] = _actions(actions_dim, cont, (8, 2), rng)
    data["prev_actions"] = _actions(actions_dim, cont, (8, 2), rng)
    if windows:
        seq, hx0, cx0 = fixed_windows({k: t(v) for k, v in data.items()}, L)
        seq = {k: v.numpy() for k, v in seq.items()}
        hx0, cx0 = hx0.numpy(), cx0.numpy()
    else:
        seq = trppo.build_sequences(data, TRAIN_KEYS, L, 2, 2)
        hx0, cx0 = seq.pop("hx0"), seq.pop("cx0")
    n = seq["mask"].shape[1]
    opt_cfg = cfg["algo"]["optimizer"]
    tx = joptim.adam(opt_cfg["lr"], tuple(opt_cfg["betas"]), opt_cfg["eps"], opt_cfg["weight_decay"], 0.5)
    local_train = jrppo.make_local_train(
        types.SimpleNamespace(data_axis="data"), jag, tx, jdotdict(cfg), ["state"], use_mesh=False, sequence_dones=windows
    )
    key = jax.random.PRNGKey(11)
    j_params, j_opt, j_metrics = jax.jit(local_train)(
        params, tx.init(params), jax.tree.map(j, seq), j(hx0), j(cx0), key, np.float32(0.2), np.float32(0.01)
    )
    opt = build_optimizer(list(tag.parameters()), opt_cfg, 0.5)
    train = trppo.make_local_train(tag, opt, cfg, ["state"], None, sequence_dones=windows)
    t_metrics = train({k: t(v) for k, v in seq.items()}, t(hx0), t(cx0), torch.tensor([0.2, 0.01]), t(_jax_perms(key, 2, n)))
    np.testing.assert_allclose(t_metrics.numpy(), np.asarray(j_metrics), atol=UPDATE_TOL, rtol=UPDATE_TOL)
    want = agent_from_flax(jax.device_get(j_params))
    for name, p in tag.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=UPDATE_TOL, rtol=UPDATE_TOL, err_msg=name)
    assert int(opt.count) == 4


def test_host_update_gathers_the_sequences_build_sequences_cuts():
    """The host path's update gathers its sequences on the device from the
    rollout by the layout: the same tensors ``build_sequences`` cuts."""
    data = _rollout_np(4, steps=10, envs=3)
    layout = trppo.sequence_layout(data["dones"][..., 0], 4, 2)
    want = trppo.build_sequences(data, TRAIN_KEYS, 4, 3, 2)
    idx, mask = t(layout.index), t(layout.mask)
    for k in TRAIN_KEYS:
        np.testing.assert_array_equal(trppo._gather(t(data[k]), idx, mask).numpy(), want[k])
    hx0 = t(data["prev_hx"]).reshape(-1, 8)[t(layout.start)] * t(layout.valid)
    np.testing.assert_array_equal(hx0.numpy(), want["hx0"])


def test_fused_superstep_matches_the_host_loop():
    """The recurrent superstep (CartPole twin, 8 steps of 4 envs, windows
    of 4) against the port's host loop on the same twin, from the same
    generator states: every rollout tensor, the stored states, GAE, the
    windows and the parameters after the update within ``ROLLOUT_TOL``.
    One env starts three steps short of its limit, so the truncation
    bootstrap with the post-step state runs."""
    steps, envs, seq_len = 8, 4, 4
    spec = get_jittable_env("CartPole-v1")
    cfg = _cfg(update_epochs=2, per_rank_num_batches=2)
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    agents = [tagent.build_agent((2,), False, cfg, space, device="cpu")[0] for _ in range(2)]
    opts = [build_optimizer(list(a.parameters()), cfg["algo"]["optimizer"], 0.5) for a in agents]
    gens = {k: [torch.Generator().manual_seed(s) for _ in range(2)] for k, s in (("policy", 1), ("env", 2), ("train", 3))}
    carry = init_recurrent_env_carry(spec, envs, gens["env"][0], 8, 2)
    gens["env"][1].set_state(gens["env"][0].get_state())
    (step_count,) = [k for k in carry if k.endswith("/t")]
    carry[step_count][0] = 497  # truncates at step index 2
    host_env = TwinVectorEnv(spec, carry, gens["env"][1], 2)
    seen = []

    def recording(agent, opt, gen):
        train = trppo.make_local_train(agent, opt, cfg, ["state"], gen, sequence_dones=True)

        def local_train(seq, hx0, cx0, coefs):
            seen.append(({k: v.clone() for k, v in seq.items()}, hx0.clone(), cx0.clone()))
            return train(seq, hx0, cx0, coefs)

        return local_train

    superstep = make_recurrent_onpolicy_superstep_fn(
        spec,
        policy_fn=lambda obs, pa, h, c, g: tagent.recurrent_rollout_step(agents[0], obs, pa, h, c, g),
        value_fn=lambda obs, pa, h, c: agents[0](obs, pa, h, c)[1],
        local_train=recording(agents[0], opts[0], gens["train"][0]),
        obs_key="state",
        rollout_steps=steps,
        seq_len=seq_len,
        gamma=0.99,
        gae_lambda=0.95,
        reset_on_done=True,
        policy_generator=gens["policy"][0],
        env_generator=gens["env"][0],
    )
    coefs = torch.tensor([0.2, 0.01])
    f_metrics, ep_stats = superstep(carry, coefs)

    player = tagent.RecurrentPPOPlayer(agents[1], torch.device("cpu"))
    buf = RolloutStore(steps).begin(1)
    state = (torch.zeros(envs, 2), torch.zeros(envs, 8), torch.zeros(envs, 8))
    next_obs, (pa, hx, cx), dones = trppo.collect_rollout(
        player, host_env, buf, host_env.obs(), state, gens["policy"][1], steps, 0.99, [], True
    )
    data = dict(buf.arrays())
    next_values = player.get_values(next_obs, pa, hx, cx)
    data["returns"], data["advantages"] = gae(data["rewards"], data["values"], data["dones"], next_values, 0.99, 0.95)
    seq, hx0, cx0 = fixed_windows(data, seq_len)
    h_metrics = recording(agents[1], opts[1], gens["train"][1])(seq, hx0, cx0, coefs)

    assert bool(ep_stats["done"][2, 0]) and dones[2, 0] == 1
    (f_seq, f_hx0, f_cx0), (h_seq, h_hx0, h_cx0) = seen
    assert set(f_seq) == set(h_seq)
    for k, v in f_seq.items():
        np.testing.assert_allclose(h_seq[k].numpy(), v.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL, err_msg=k)
    np.testing.assert_allclose(h_hx0.numpy(), f_hx0.numpy(), atol=ROLLOUT_TOL)
    np.testing.assert_allclose(h_cx0.numpy(), f_cx0.numpy(), atol=ROLLOUT_TOL)
    np.testing.assert_allclose(h_metrics.numpy(), f_metrics.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)
    for p, q in zip(agents[0].parameters(), agents[1].parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)
    # the carry moved on in place: the host loop's state after the rollout
    for k, v in (("hx", hx), ("cx", cx), ("prev_actions", pa)):
        np.testing.assert_allclose(carry[k].numpy(), v.numpy(), atol=ROLLOUT_TOL)


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #

RPPO = [
    "exp=ppo_recurrent",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.rollout_steps=8",
    "algo.per_rank_sequence_length=4",
    "algo.per_rank_num_batches=2",
    "algo.update_epochs=2",
    "algo.dense_units=8",
    "algo.rnn.lstm.hidden_size=8",
    "algo.encoder.cnn_features_dim=16",
    "algo.encoder.mlp_features_dim=8",
    "algo.total_steps=32",
    "metric.log_every=16",
]


def _run(tmp_path, extra, name):
    cfg = dotdict(compose("config", RPPO + [f"log_base_dir={tmp_path}", f"run_name={name}"] + extra))
    return trppo.main(cfg, device="cpu")


@pytest.mark.parametrize("env_id", ["dummy_discrete", "dummy_multidiscrete", "dummy_continuous"])
def test_main_trains_on_the_dummy_envs(tmp_path, env_id):
    """The JAX smoke test's envs and keys (``rgb`` through NatureCNN and
    ``state``): two updates, a checkpoint, the test episode."""
    out = _run(tmp_path, ["env=dummy", f"env.id={env_id}", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"], env_id)
    assert out["updates"] == 2 and out["gradient_steps"] == 8 and out["captures"] >= 1
    assert all(np.isfinite(v) for v in out["metrics"].values()) and out["test_steps"] > 0
    assert glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))


@pytest.mark.parametrize("fused", [False, True])
def test_main_checkpoints_and_resumes(tmp_path, fused):
    extra = [f"algo.fused_rollout={fused}", "algo.anneal_lr=True", "algo.anneal_ent_coef=True"]
    out = _run(tmp_path, extra, "a")
    assert out["fused_rollout"] is fused and out["updates"] == 2 and out["env_steps"] == 32
    assert out["captures"] == (1 if fused else len(out["sequence_counts"]))
    ckpts = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))
    state = load_checkpoint(ckpts[-1])
    assert {"agent", "opt_state", "update", "batch_size", "last_log", "last_checkpoint", "rng_key", "player_rng_key"} <= set(state)
    assert "ScanOptimizedLSTMCell_0" in state["agent"]["params"]
    res = _run(tmp_path, [*extra, "algo.total_steps=64", f"checkpoint.resume_from={ckpts[-1]}"], "b")
    assert res["start_update"] == 3 and res["updates"] == 2 and res["env_steps"] == 64


def test_a_forced_nan_rolls_back_to_the_last_checkpoint(tmp_path):
    cfg = dotdict(compose("config", RPPO + [f"log_base_dir={tmp_path}", "run_name=drill", "checkpoint.every=16", "algo.total_steps=64"]))
    cfg.resilience.fault_injection = {"enabled": True, "faults": [{"kind": "nan", "at_update": 3}]}
    out = trppo.main(cfg, device="cpu")
    assert out["rollbacks"] == 1 and out["updates"] == 4 and out["last_checkpoint"] == 64


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A JAX recurrent PPO checkpoint (its flax tree with the LSTM, its
    AdamW state, its threefry keys) resumes in the port, the weights and
    Adam's moments exact."""
    cfg = dotdict(compose("config", RPPO + [f"log_base_dir={tmp_path}", "run_name=j"]))
    jfab = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    _, params = jagent.build_agent(jfab, (2,), False, jdotdict(cfg.to_dict()), space)
    tx = joptim.adam(3e-4, (0.9, 0.999), 1e-8, 1e-2, 0.5)
    rng = np.random.default_rng(0)
    opt_state = jax.tree.map(lambda x: np.asarray(x) + rng.random(np.shape(x)).astype(np.float32) if np.ndim(x) else x, jax.device_get(tx.init(params)))
    path = str(tmp_path / "jax.ckpt")
    key = jax.random.PRNGKey(0)
    state = {"agent": params, "opt_state": opt_state, "update": 1, "batch_size": 64, "last_log": 0, "last_checkpoint": 16}
    jax_save_checkpoint(path, {**state, "rng_key": key, "player_rng_key": key})
    cfg.checkpoint.resume_from = path
    with pytest.warns(UserWarning, match="not a torch generator state"):
        out = trppo.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["updates"] == 1
    loaded = load_checkpoint(path)
    tag, _ = tagent.build_agent((2,), False, cfg, space, agent_from_flax(loaded["agent"]), device="cpu")
    for name, p in tag.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), agent_from_flax(jax.device_get(params))[name].numpy())
    opt = build_optimizer(list(tag.parameters()), cfg.algo.optimizer, 0.5)
    names = [n for n, _ in tag.named_parameters()]
    optimizer_from_optax(loaded["opt_state"], opt, names, agent_from_flax)
    want = agent_from_flax(opt_state[1][0].mu)
    for name, mu in zip(names, opt.mu):
        np.testing.assert_array_equal(mu.numpy(), want[name].numpy())


@pytest.mark.parametrize(
    "extra, reason",
    [
        (["env=dummy", "env.id=dummy_discrete"], "jittable_env"),
        (["algo.rollout_steps=6"], "recurrent_seq"),
        (["algo.per_rank_num_batches=3"], "sequence_batches"),
    ],
)
def test_the_fused_gate_falls_back_with_one_event(tmp_path, monkeypatch, extra, reason):
    events = []
    monkeypatch.setattr(trppo, "fused_fallback", lambda r, detail: events.append(r))
    monkeypatch.setattr("sheeprl_tpu_torch.algos.ppo.ppo.fused_fallback", lambda r, detail: events.append(r))
    out = _run(tmp_path, ["algo.fused_rollout=True", "algo.total_steps=16", *extra], "g")
    assert events == [reason] and out["fused_rollout"] is False and out["updates"] == 1


def test_cli_dry_run_checkpoints_resumes_and_evaluates(tmp_path):
    argv = ["exp=ppo_recurrent", "fabric=cpu", "dry_run=True", "env.capture_video=False", "env.backend=sync", "algo.rollout_steps=16"]
    argv += [f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "ppo_recurrent" / "CartPole-v1" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    assert load_checkpoint(ckpt)["update"] == 1
    cli.run(argv + [f"checkpoint.resume_from={ckpt}"])
    cli.evaluation([f"checkpoint_path={ckpt}"])
