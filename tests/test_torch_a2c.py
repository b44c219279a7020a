"""A2C in the port against the JAX package on the CPU: the agent (PPO's
over the vector keys), the losses, one whole update through
``make_local_train`` with RMSProp (discrete, multi-discrete, continuous;
fp32 and bf16-mixed), the fused superstep against the port's host loop,
and ``python -m sheeprl_tpu_torch exp=a2c`` end to end: the dummy envs,
checkpoints, resumes (the port's and the JAX package's), ``cli_eval``, a
CLI dry run.

Weights come from the JAX init, shifted by seeded noise, carried across
with PPO's ``convert``; inputs are numpy draws from a seed. A2C's update
draws nothing, so no permutation is injected.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.a2c import a2c as ja2c
from sheeprl_tpu.algos.a2c import agent as jagent
from sheeprl_tpu.algos.a2c import loss as jloss
from sheeprl_tpu.algos.ppo import agent as jppo_agent
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.a2c import a2c as ta2c
from sheeprl_tpu_torch.algos.a2c import agent as tagent
from sheeprl_tpu_torch.algos.a2c import loss as tloss
from sheeprl_tpu_torch.algos.dreamer_v3.convert import _nesting, optimizer_from_optax, optimizer_to_optax
from sheeprl_tpu_torch.algos.ppo import agent as tppo_agent
from sheeprl_tpu_torch.algos.ppo import ppo as tppo
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax, agent_to_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.jittable import get_jittable_env
from sheeprl_tpu_torch.ops.optim import RMSProp, build_optimizer
from sheeprl_tpu_torch.ops.rollout_scan import init_env_carry, make_onpolicy_superstep_fn
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.prealloc import RolloutStore
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_precision import EPS, TRAIN_GRAD_TOL, TRAIN_TOL
from tests.test_torch_rollout_scan import TwinVectorEnv

FWD_TOL = 1e-5
UPDATE_TOL = 1e-5
ROLLOUT_TOL = 1e-6
N_LOCAL = 20

# (actions_dim, is_continuous)
KINDS = {"discrete": ((3,), False), "multi_discrete": ((3, 2), False), "continuous": ((2,), True)}


def _cfg(precision="32-true"):
    return {
        "seed": 3,
        "fabric": {"precision": precision},
        "algo": {
            "cnn_keys": {"encoder": ["rgb"]},  # dropped: A2C reads vectors only
            "mlp_keys": {"encoder": ["state"]},
            "encoder": {"mlp_features_dim": 8, "dense_units": 16, "mlp_layers": 1},
            "actor": {"dense_units": 16, "mlp_layers": 2},
            "critic": {"dense_units": 16, "mlp_layers": 2},
            "dense_act": "tanh",
            "layer_norm": False,
            "loss_reduction": "sum",
            "optimizer": {"_target_": "sheeprl_tpu_torch.ops.optim.rmsprop", "lr": 1e-3, "eps": 1e-4, "alpha": 0.99, "momentum": 0, "centered": False, "weight_decay": 0},
            "max_grad_norm": 0.5,
        },
    }


SPACE = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (5,), np.float32), "rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})


def _pair(kind, precision="32-true", seed=0):
    actions_dim, cont = KINDS[kind]
    cfg = _cfg(precision)
    jfab = JaxFabric(devices=1, precision=precision, accelerator="cpu")
    jag, params = jagent.build_agent(jfab, actions_dim, cont, jdotdict(cfg), SPACE)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), jax.device_get(params))
    tag, _ = tagent.build_agent(actions_dim, cont, cfg, SPACE, agent_from_flax(params), device="cpu")
    return jag, params, tag, cfg


def _rollout(kind, seed=5):
    actions_dim, cont = KINDS[kind]
    rng = np.random.default_rng(seed)
    data = {"state": rng.standard_normal((N_LOCAL, 5)).astype(np.float32)}
    if cont:
        data["actions"] = rng.standard_normal((N_LOCAL, sum(actions_dim))).astype(np.float32)
    else:
        data["actions"] = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, N_LOCAL)] for d in actions_dim], -1)
    for k in ("returns", "advantages"):
        data[k] = rng.standard_normal((N_LOCAL, 1)).astype(np.float32)
    return data


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("kind", list(KINDS))
def test_agent_reads_vectors_only_and_matches_jax(kind):
    jag, params, tag, _ = _pair(kind)
    assert tag.cnn_encoder is None and tag.cnn_keys == ()
    obs = {"state": np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)}
    acts = _rollout(kind)["actions"][:6]
    want = jppo_agent.evaluate_actions(jag, params, {"state": jnp.asarray(obs["state"])}, jnp.asarray(acts))
    with torch.no_grad():
        got = tagent.evaluate_actions(tag, {"state": t(obs["state"])}, t(acts))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_losses_match_jax(reduction):
    a, b, c = np.random.default_rng(2).standard_normal((3, 16, 1)).astype(np.float32)
    np.testing.assert_allclose(tloss.policy_loss(t(a), t(b), reduction).numpy(), np.asarray(jloss.policy_loss(a, b, reduction)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tloss.value_loss(t(a), t(c), reduction).numpy(), np.asarray(jloss.value_loss(a, c, reduction)), rtol=1e-6, atol=1e-6)


def _jax_update(jag, params, cfg, data):
    algo = cfg["algo"]
    tx = joptim.rmsprop(lr=1e-3, alpha=0.99, eps=1e-4, max_grad_norm=float(algo["max_grad_norm"]))
    local_train = ja2c.make_local_train(types.SimpleNamespace(data_axis="data"), jag, tx, jdotdict(cfg), ["state"], use_mesh=False)
    new_params, new_opt, metrics = jax.jit(local_train)(params, tx.init(params), {k: jnp.asarray(v) for k, v in data.items()})
    return jax.device_get(new_params), jax.device_get(new_opt), np.asarray(metrics)


def _port_update(tag, cfg, data):
    algo = cfg["algo"]
    opt = build_optimizer(list(tag.parameters()), algo["optimizer"], float(algo["max_grad_norm"]))
    metrics = ta2c.make_local_train(tag, opt, cfg, ["state"], N_LOCAL)({k: t(v) for k, v in data.items()})
    return opt, metrics


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1.0))


@pytest.mark.parametrize("kind", list(KINDS))
def test_update_matches_jax_local_train(kind):
    """One full-rollout gradient step of the summed losses through RMSProp
    behind clipping: the metrics and every parameter within
    ``UPDATE_TOL``, the RMSProp state in optax's nesting and values."""
    jag, params, tag, cfg = _pair(kind)
    data = _rollout(kind)
    j_params, j_opt, j_metrics = _jax_update(jag, params, cfg, data)
    opt, t_metrics = _port_update(tag, cfg, data)
    assert isinstance(opt, RMSProp)
    np.testing.assert_allclose(t_metrics.numpy(), j_metrics, atol=UPDATE_TOL, rtol=UPDATE_TOL)
    want = agent_from_flax(j_params)
    for name, p in tag.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=UPDATE_TOL, rtol=UPDATE_TOL, err_msg=name)
    state = optimizer_to_optax(opt, [n for n, _ in tag.named_parameters()], agent_to_flax)
    assert _nesting(state) == _nesting(j_opt)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(j_opt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=UPDATE_TOL, rtol=UPDATE_TOL)


def test_update_matches_jax_at_bf16_mixed():
    jag, params, tag, cfg = _pair("discrete", precision="bf16-mixed")
    assert tag.dtype == torch.bfloat16
    data = _rollout("discrete")
    j_params, _, j_metrics = _jax_update(jag, params, cfg, data)
    _, t_metrics = _port_update(tag, cfg, data)
    assert _rel(t_metrics, j_metrics) <= TRAIN_TOL, _rel(t_metrics, j_metrics) / EPS
    want = agent_from_flax(j_params)
    for name, p in tag.named_parameters():
        assert p.dtype == torch.float32
        assert _rel(p, want[name]) <= TRAIN_GRAD_TOL, (name, _rel(p, want[name]) / EPS)


def test_fused_superstep_matches_the_host_loop():
    """The A2C superstep (CartPole twin, 8 steps of 4 envs) against the
    port's host loop on the same twin, from the same generator states: the
    rollout, GAE and the parameters after the step within ``ROLLOUT_TOL``.
    No env truncates (the host loop has no truncation bootstrap)."""
    steps, envs = 8, 4
    spec = get_jittable_env("CartPole-v1")
    cfg = _cfg()
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    agents = [tagent.build_agent((2,), False, cfg, space, device="cpu")[0] for _ in range(2)]
    opts = [build_optimizer(list(a.parameters()), cfg["algo"]["optimizer"], 0.5) for a in agents]
    gens = {k: [torch.Generator().manual_seed(s) for _ in range(2)] for k, s in (("policy", 1), ("env", 2))}
    carry = init_env_carry(spec, envs, gens["env"][0])
    gens["env"][1].set_state(gens["env"][0].get_state())
    host_env = TwinVectorEnv(spec, carry, gens["env"][1], 2)
    seen = []

    def recording(agent, opt):
        train = ta2c.make_local_train(agent, opt, cfg, ["state"], steps * envs)

        def local_train(flat, coefs):
            seen.append({k: v.clone() for k, v in flat.items()})
            return train(flat, coefs)

        return local_train

    superstep = make_onpolicy_superstep_fn(
        spec,
        policy_fn=lambda obs, g: tppo_agent.rollout_step(agents[0], obs, g),
        value_fn=lambda obs: agents[0](obs)[1],
        local_train=recording(agents[0], opts[0]),
        obs_key="state",
        rollout_steps=steps,
        gamma=0.99,
        gae_lambda=1.0,
        policy_generator=gens["policy"][0],
        env_generator=gens["env"][0],
    )
    coefs = torch.zeros(2)
    f_metrics, _ = superstep(carry, coefs)
    player = tppo_agent.PPOPlayer(agents[1], torch.device("cpu"))
    buf = RolloutStore(steps).begin(1)
    next_obs = tppo.collect_rollout(player, host_env, buf, host_env.obs(), gens["policy"][1], steps, 0.99, [], bootstrap=False)
    inputs = dict(buf.arrays())
    inputs["next/state"] = torch.from_numpy(next_obs["state"])
    inputs["coefs"] = coefs
    host_cfg = {**cfg, "algo": {**cfg["algo"], "gamma": 0.99, "gae_lambda": 1.0}}
    h_metrics = tppo.make_update_fn(agents[1], recording(agents[1], opts[1]), host_cfg, ["state"])(inputs)
    fused, host = seen
    for k, v in fused.items():
        np.testing.assert_allclose(host[k].numpy(), v.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL, err_msg=k)
    np.testing.assert_allclose(h_metrics.numpy(), f_metrics.numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)
    for p, q in zip(agents[0].parameters(), agents[1].parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), atol=ROLLOUT_TOL, rtol=ROLLOUT_TOL)


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #

A2C = [
    "exp=a2c",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.rollout_steps=8",
    "algo.dense_units=8",
    "algo.total_steps=32",
    "metric.log_every=16",
]


def _run(tmp_path, extra, name):
    cfg = dotdict(compose("config", A2C + [f"log_base_dir={tmp_path}", f"run_name={name}"] + extra))
    return ta2c.main(cfg, device="cpu")


@pytest.mark.parametrize("env_id", ["dummy_discrete", "dummy_multidiscrete", "dummy_continuous"])
def test_main_trains_on_the_dummy_envs(tmp_path, env_id):
    out = _run(tmp_path, ["env=dummy", f"env.id={env_id}", "algo.cnn_keys.encoder=[rgb]"], env_id)
    assert out["updates"] == 2 and out["gradient_steps"] == 2 and out["env_steps"] == 32
    assert set(out["metrics"]) == set(ta2c.METRIC_ORDER) and all(np.isfinite(v) for v in out["metrics"].values())
    (ckpt, *_) = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))
    assert _nesting(load_checkpoint(ckpt)["opt_state"]) == ("EmptyState", ("ScaleByRmsState", "EmptyState", "EmptyState"))


@pytest.mark.parametrize("fused", [False, True])
def test_main_checkpoints_and_resumes(tmp_path, fused):
    out = _run(tmp_path, [f"algo.fused_rollout={fused}"], "a")
    assert out["fused_rollout"] is fused and out["updates"] == 2 and out["test_steps"] > 0
    ckpts = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))
    state = load_checkpoint(ckpts[-1])
    assert state["update"] == 2 and state["batch_size"] == 8
    res = _run(tmp_path, [f"algo.fused_rollout={fused}", "algo.total_steps=64", f"checkpoint.resume_from={ckpts[-1]}"], "b")
    assert res["start_update"] == 3 and res["updates"] == 2 and res["env_steps"] == 64


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A JAX A2C checkpoint (its agent, its optax RMSProp state) resumes in
    the port: the weights and RMSProp's ``nu`` load exactly."""
    cfg = dotdict(compose("config", A2C + [f"log_base_dir={tmp_path}", "run_name=j"]))
    jfab = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    _, params = jagent.build_agent(jfab, (2,), False, jdotdict(cfg.to_dict()), space)
    tx = joptim.rmsprop(lr=1e-3, alpha=0.99, eps=1e-4, max_grad_norm=0.5)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    opt_state = jax.tree.map(lambda x: np.asarray(x) + rng.random(np.shape(x)).astype(np.float32), jax.device_get(opt_state))
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, {"agent": params, "opt_state": opt_state, "update": 1, "batch_size": 8, "last_log": 0, "last_checkpoint": 16})
    cfg.checkpoint.resume_from = path
    out = ta2c.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["updates"] == 1
    loaded = load_checkpoint(path)
    tag, _ = tagent.build_agent((2,), False, cfg, space, agent_from_flax(loaded["agent"]), device="cpu")
    names = [n for n, _ in tag.named_parameters()]
    opt = build_optimizer(list(tag.parameters()), cfg.algo.optimizer, 0.5)
    optimizer_from_optax(loaded["opt_state"], opt, names, agent_from_flax)
    want = agent_from_flax(opt_state[1][0].nu)
    for name, nu in zip(names, opt.nu):
        np.testing.assert_array_equal(nu.numpy(), want[name].numpy())
    for name, p in tag.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), agent_from_flax(jax.device_get(params))[name].numpy())


def test_cli_dry_run_checkpoints_resumes_and_evaluates(tmp_path):
    argv = ["exp=a2c", "fabric=cpu", "dry_run=True", "env.capture_video=False", "env.backend=sync", f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "a2c" / "CartPole-v1" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    assert load_checkpoint(ckpt)["update"] == 1
    cli.run(argv + [f"checkpoint.resume_from={ckpt}"])
    cli.evaluation([f"checkpoint_path={ckpt}"])
