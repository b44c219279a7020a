"""PPO in the port against the JAX package on the CPU: the agent's
forward, log-probs, entropy and values (discrete, multi-discrete,
continuous, NatureCNN), ``gae``, the losses, one whole update through
``make_local_train`` (fp32, bf16-mixed, and the dtypes of bf16-true), the
checkpoint layout both ways, and ``python -m sheeprl_tpu_torch exp=ppo``
end to end (host loop and fused rollout, a checkpoint, a resume,
``cli_eval`` and the fallback of a twin-less env).

Weights come from the JAX init, shifted by seeded noise, carried across
with ``convert``; inputs are numpy draws from a seed. JAX threefry and
torch generators never draw the same samples, so the update takes the JAX
permutations, reproduced from its key splits, as ``perms``.
"""

import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jagent
from sheeprl_tpu.algos.ppo import loss as jloss
from sheeprl_tpu.algos.ppo import ppo as jppo
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.convert import _nesting, adam_from_optax, adam_to_optax
from sheeprl_tpu_torch.algos.ppo import agent as tagent
from sheeprl_tpu_torch.algos.ppo import loss as tloss
from sheeprl_tpu_torch.algos.ppo import ppo as tppo
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax, agent_to_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.ops.optim import adam as tadam
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_precision import EPS, TRAIN_GRAD_TOL, TRAIN_TOL

FWD_TOL = 1e-5
GAE_TOL = 1e-6
UPDATE_TOL = 1e-4

# (actions_dim, is_continuous, cnn_keys, mlp_keys)
AGENTS = {
    "discrete": ((3,), False, (), ("state",)),
    "multi_discrete": ((3, 2), False, (), ("state",)),
    "continuous": ((2,), True, (), ("state",)),
    "nature_cnn": ((4,), False, ("rgb",), ("state",)),
}


def _cfg(precision="32-true", **algo):
    base = {
        "seed": 3,
        "fabric": {"precision": precision},
        "algo": {
            "cnn_keys": {"encoder": []},
            "mlp_keys": {"encoder": ["state"]},
            "encoder": {"cnn_features_dim": 32, "mlp_features_dim": 8, "dense_units": 16, "mlp_layers": 2},
            "actor": {"dense_units": 16, "mlp_layers": 2},
            "critic": {"dense_units": 16, "mlp_layers": 2},
            "dense_act": "tanh",
            "layer_norm": False,
            "per_rank_batch_size": 8,
            "update_epochs": 2,
            "vf_coef": 0.5,
            "clip_vloss": True,
            "normalize_advantages": True,
            "loss_reduction": "mean",
            "optimizer": {"lr": 1e-3, "eps": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.0},
            "max_grad_norm": 0.5,
        },
    }
    base["algo"].update(algo)
    return base


def _space(cnn_keys, mlp_keys):
    d = {k: spaces.Box(0, 255, (64, 64, 3), np.uint8) for k in cnn_keys}
    d.update({k: spaces.Box(-np.inf, np.inf, (5,), np.float32) for k in mlp_keys})
    return spaces.Dict(d)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def _obs(cnn_keys, mlp_keys, n, seed=0):
    rng = np.random.default_rng(seed)
    obs = {k: rng.integers(0, 256, (n, 64, 64, 3)).astype(np.uint8) for k in cnn_keys}
    obs.update({k: rng.standard_normal((n, 5)).astype(np.float32) for k in mlp_keys})
    return obs


def _pair(kind, precision="32-true", seed=0):
    """(JAX agent, perturbed JAX params, port agent) from the same weights."""
    actions_dim, cont, cnn_keys, mlp_keys = AGENTS[kind]
    cfg = _cfg(precision)
    cfg["algo"]["cnn_keys"]["encoder"] = list(cnn_keys)
    cfg["algo"]["mlp_keys"]["encoder"] = list(mlp_keys)
    space = _space(cnn_keys, mlp_keys)
    jfab = JaxFabric(devices=1, precision=precision, accelerator="cpu")
    jag, params = jagent.build_agent(jfab, actions_dim, cont, jdotdict(cfg), space)
    params = _perturb(jax.device_get(params), seed)
    if precision == "bf16-true":
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tag, _ = tagent.build_agent(actions_dim, cont, cfg, space, agent_from_flax(jax.device_get(params)), device="cpu")
    return jag, params, tag, cfg


def _actions(kind, n, seed=1):
    actions_dim, cont, *_ = AGENTS[kind]
    rng = np.random.default_rng(seed)
    if cont:
        return rng.standard_normal((n, sum(actions_dim))).astype(np.float32)
    return np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, n)] for d in actions_dim], -1)


def t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# the agent
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", list(AGENTS))
def test_agent_matches_jax(kind):
    jag, params, tag, _ = _pair(kind)
    obs = _obs(*AGENTS[kind][2:], n=6)
    acts = _actions(kind, 6)
    j_lp, j_ent, j_v = jagent.evaluate_actions(jag, params, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(acts))
    with torch.no_grad():
        t_lp, t_ent, t_v = tagent.evaluate_actions(tag, {k: t(v) for k, v in obs.items()}, t(acts))
    for got, want in ((t_lp, j_lp), (t_ent, j_ent), (t_v, j_v)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    # the greedy action and its log-prob
    j_act, j_glp, _ = jagent.sample_actions(jag, params, {k: jnp.asarray(v) for k, v in obs.items()}, jax.random.PRNGKey(0), greedy=True)
    with torch.no_grad():
        t_act, t_glp, _ = tagent.sample_actions(tag, {k: t(v) for k, v in obs.items()}, greedy=True)
    np.testing.assert_allclose(t_act.numpy(), np.asarray(j_act), atol=FWD_TOL)
    np.testing.assert_allclose(t_glp.numpy(), np.asarray(j_glp), atol=FWD_TOL, rtol=FWD_TOL)
    real = tagent.real_actions_from_onehot(tag.actions_dim, tag.is_continuous, t_act)
    want = jagent.real_actions_from_onehot(jag.actions_dim, jag.is_continuous, j_act)
    np.testing.assert_allclose(real.numpy(), np.asarray(want), atol=FWD_TOL)


def test_sampled_actions_follow_the_policy():
    """Sampling (Gumbel-max, the same rule as ``jax.random.categorical``)
    against the policy's probabilities, and the log-prob of the sample."""
    _, _, tag, _ = _pair("multi_discrete")
    obs = {"state": t(np.repeat(_obs((), ("state",), 1)["state"], 4000, 0))}
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        acts, lp, _ = tagent.sample_actions(tag, obs, g)
        heads, _ = tag(obs)
    for part, head in zip(torch.split(acts, list(tag.actions_dim), -1), heads):
        np.testing.assert_allclose(part.mean(0).numpy(), torch.softmax(head[0], -1).numpy(), atol=0.03)
    lp2, _, _ = tagent.evaluate_actions(tag, obs, acts)
    np.testing.assert_allclose(lp.numpy(), lp2.detach().numpy(), atol=1e-6)


def test_convert_round_trips_and_permutes_the_cnn_features():
    jag, params, tag, _ = _pair("nature_cnn")
    back = agent_to_flax(tag.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # the feature Dense's rows: flax's HWC order against the port's CHW
    k = np.asarray(params["params"]["CNNEncoder_0"]["NatureCNN_0"]["Dense_0"]["kernel"])
    w = tag.cnn_encoder.cnn.fc.weight.detach().numpy()
    c, h, wd = tag.cnn_encoder.cnn.map_shape
    assert np.array_equal(w[:, (1 * h + 2) * wd + 3], k[(2 * wd + 3) * c + 1])


# --------------------------------------------------------------------------- #
# gae and the losses
# --------------------------------------------------------------------------- #


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r, v = rng.standard_normal((2, 16, 4, 1)).astype(np.float32)
    d = (rng.random((16, 4, 1)) < 0.2).astype(np.float32)
    nv = rng.standard_normal((4, 1)).astype(np.float32)
    j_ret, j_adv = jm.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(nv), 0.99, 0.95)
    t_ret, t_adv = tm.gae(t(r), t(v), t(d), t(nv), 0.99, 0.95)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), atol=GAE_TOL, rtol=GAE_TOL)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), atol=GAE_TOL, rtol=GAE_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(1)
    a, b, c, d = rng.standard_normal((4, 32, 1)).astype(np.float32)
    pairs = [
        (tloss.policy_loss(t(a), t(b), t(c), 0.2, reduction), jloss.policy_loss(a, b, c, 0.2, reduction)),
        (tloss.value_loss(t(a), t(b), t(c), 0.2, True, reduction), jloss.value_loss(a, b, c, 0.2, True, reduction)),
        (tloss.value_loss(t(a), t(b), t(c), 0.2, False, reduction), jloss.value_loss(a, b, c, 0.2, False, reduction)),
        (tloss.entropy_loss(t(d), reduction), jloss.entropy_loss(d, reduction)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# one update through make_local_train
# --------------------------------------------------------------------------- #

N_LOCAL = 32


def _rollout(kind, seed=5):
    rng = np.random.default_rng(seed)
    data = _obs(*AGENTS[kind][2:], n=N_LOCAL, seed=seed)
    data["actions"] = _actions(kind, N_LOCAL, seed + 1)
    for k in ("logprobs", "values", "returns", "advantages"):
        data[k] = rng.standard_normal((N_LOCAL, 1)).astype(np.float32)
    return data


def _jax_update(jag, params, cfg, data, anneal_steps):
    algo = cfg["algo"]
    opt = algo["optimizer"]
    sched = None
    if anneal_steps:
        import optax

        sched = optax.linear_schedule(float(opt["lr"]), 0.0, anneal_steps)
    tx = joptim.adam(opt["lr"], tuple(opt["betas"]), opt["eps"], 0.0, float(algo["max_grad_norm"]), sched)
    obs_keys = list(algo["cnn_keys"]["encoder"]) + list(algo["mlp_keys"]["encoder"])
    local_train = jppo.make_local_train(types.SimpleNamespace(data_axis="data"), jag, tx, jdotdict(cfg), obs_keys, N_LOCAL, use_mesh=False)
    key = jax.random.PRNGKey(7)
    opt_state = tx.init(params)
    new_params, new_opt, metrics = jax.jit(local_train)(
        params, opt_state, {k: jnp.asarray(v) for k, v in data.items()}, key, np.float32(0.2), np.float32(0.01)
    )
    perms = []
    for _ in range(int(algo["update_epochs"])):
        key, perm_key = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(perm_key, N_LOCAL)))
    return jax.device_get(new_params), jax.device_get(new_opt), np.asarray(metrics), np.stack(perms)


def _port_update(tag, cfg, data, perms, anneal_steps):
    algo = cfg["algo"]
    opt = tadam(list(tag.parameters()), algo["optimizer"], float(algo["max_grad_norm"]), schedule_steps=anneal_steps)
    obs_keys = list(algo["cnn_keys"]["encoder"]) + list(algo["mlp_keys"]["encoder"])
    local_train = tppo.make_local_train(tag, opt, cfg, obs_keys, N_LOCAL, None)
    metrics = local_train({k: t(v) for k, v in data.items()}, torch.tensor([0.2, 0.01]), t(perms))
    return opt, metrics


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1.0))


@pytest.mark.parametrize("kind, anneal", [("discrete", 0), ("continuous", 16), ("nature_cnn", 0)])
def test_update_matches_jax_local_train(kind, anneal):
    """Two epochs of four minibatches with normalized advantages, clipped
    values, global-norm clipping and, for one case, the annealed learning
    rate: every parameter within ``UPDATE_TOL``, the metrics too."""
    jag, params, tag, cfg = _pair(kind)
    data = _rollout(kind)
    j_params, j_opt, j_metrics, perms = _jax_update(jag, params, cfg, data, anneal)
    opt, t_metrics = _port_update(tag, cfg, data, perms, anneal)
    np.testing.assert_allclose(t_metrics.numpy(), j_metrics, atol=UPDATE_TOL, rtol=UPDATE_TOL)
    want = agent_from_flax(j_params)
    for name, p in tag.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=UPDATE_TOL, rtol=UPDATE_TOL, err_msg=name)
    # the optimizer state in optax's nesting, both ways
    names = [n for n, _ in tag.named_parameters()]
    state = adam_to_optax(opt, names, agent_to_flax)
    assert _nesting(state) == _nesting(j_opt)
    assert jax.tree.structure(state[1][0].mu) == jax.tree.structure(j_opt[1][0].mu)
    opt2 = tadam(list(tag.parameters()), cfg["algo"]["optimizer"], 0.5, schedule_steps=anneal)
    adam_from_optax(j_opt, opt2, names, agent_from_flax)
    assert int(opt2.count) == int(opt.count) == 8
    for a, b in zip(opt2.mu, opt.mu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=UPDATE_TOL)


def test_update_matches_jax_at_bf16_mixed():
    """The same update at bf16-mixed: the losses within ``TRAIN_TOL`` and
    the parameters within ``TRAIN_GRAD_TOL`` relative to the largest, the
    bounds of ``tests/test_torch_precision.py``."""
    jag, params, tag, cfg = _pair("nature_cnn", precision="bf16-mixed")
    assert jag.dtype == jnp.bfloat16 and tag.dtype == torch.bfloat16
    data = _rollout("nature_cnn")
    j_params, _, j_metrics, perms = _jax_update(jag, params, cfg, data, 0)
    _, t_metrics = _port_update(tag, cfg, data, perms, 0)
    assert _rel(t_metrics, j_metrics) <= TRAIN_TOL, _rel(t_metrics, j_metrics) / EPS
    want = agent_from_flax(j_params)
    for name, p in tag.named_parameters():
        assert p.dtype == torch.float32
        assert _rel(p, want[name]) <= TRAIN_GRAD_TOL, (name, _rel(p, want[name]) / EPS)


def test_bf16_true_holds_bf16_parameters_and_moments():
    jag, params, tag, cfg = _pair("discrete", precision="bf16-true")
    assert all(np.asarray(x).dtype == jnp.bfloat16 for x in jax.tree.leaves(params))
    assert all(p.dtype == torch.bfloat16 for p in tag.parameters())
    data = _rollout("discrete")
    _, j_opt, _, perms = _jax_update(jag, params, cfg, data, 0)
    opt, metrics = _port_update(tag, cfg, data, perms, 0)
    j_adam = j_opt[1][0]
    assert all(np.asarray(x).dtype == jnp.bfloat16 for x in jax.tree.leaves((j_adam.mu, j_adam.nu)))
    assert all(m.dtype == torch.bfloat16 for m in [*opt.mu, *opt.nu])
    assert all(p.dtype == torch.bfloat16 for p in tag.parameters())
    assert metrics.dtype == torch.float32 and torch.isfinite(metrics).all()


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #

PPO = [
    "exp=ppo",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.rollout_steps=16",
    "algo.per_rank_batch_size=8",
    "algo.update_epochs=2",
    "algo.total_steps=64",
    "algo.dense_units=8",
    "algo.encoder.mlp_features_dim=8",
    "metric.log_every=32",
]


def _run(tmp_path, extra, name):
    cfg = dotdict(compose("config", PPO + [f"log_base_dir={tmp_path}", f"run_name={name}"] + extra))
    return tppo.main(cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_main_trains_checkpoints_and_resumes(tmp_path, fused):
    anneal = ["algo.anneal_lr=True", "algo.anneal_clip_coef=True"]
    out = _run(tmp_path, [f"algo.fused_rollout={fused}", *anneal], "a")
    assert out["fused_rollout"] is fused and out["updates"] == 2 and out["env_steps"] == 64
    assert out["gradient_steps"] == 2 * 2 * 4 and out["replays"] == 0  # eager on the CPU
    assert all(np.isfinite(v) for v in out["metrics"].values()) and out["test_steps"] > 0
    ckpts = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))
    state = load_checkpoint(ckpts[-1])
    assert {"agent", "opt_state", "update", "batch_size", "last_log", "last_checkpoint"} <= set(state)
    assert state["update"] == 2 and state["batch_size"] == 8
    # resume: two more updates from the checkpoint
    res = _run(tmp_path, [f"algo.fused_rollout={fused}", *anneal, "algo.total_steps=128", f"checkpoint.resume_from={ckpts[-1]}"], "b")
    assert res["start_update"] == 3 and res["updates"] == 2 and res["env_steps"] == 128


@pytest.mark.parametrize("fused", [False, True])
def test_a_forced_nan_rolls_back_to_the_last_checkpoint(tmp_path, fused):
    """The resilience plane as Dreamer-V3 wires it: non-finite metrics at
    update 3 restore update 2's checkpoint in place and the run goes on."""
    cfg = dotdict(compose("config", PPO + [f"log_base_dir={tmp_path}", "run_name=drill", f"algo.fused_rollout={fused}", "checkpoint.every=32", "algo.total_steps=128"]))
    cfg.resilience.fault_injection = {"enabled": True, "faults": [{"kind": "nan", "at_update": 3}]}
    out = tppo.main(cfg, device="cpu")
    assert out["rollbacks"] == 1 and out["updates"] == 4 and out["last_checkpoint"] == 128
    assert all(np.isfinite(v) for v in out["metrics"].values())


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its agent, its optax state and
    its threefry keys) resumes in the port: the weights and Adam state
    load, the keys reseed the generators with a warning."""
    cfg = dotdict(compose("config", PPO + [f"log_base_dir={tmp_path}", "run_name=j"]))
    jfab = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    jag, params = jagent.build_agent(jfab, (2,), False, jdotdict(cfg.to_dict()), space)
    tx = joptim.adam(1e-3, (0.9, 0.999), 1e-4)
    opt_state = tx.init(params)
    path = str(tmp_path / "jax.ckpt")
    key = jax.random.PRNGKey(0)
    state = {"agent": params, "opt_state": opt_state, "update": 1, "batch_size": 8, "last_log": 0, "last_checkpoint": 32}
    jax_save_checkpoint(path, {**state, "rng_key": key, "player_rng_key": key})
    cfg.checkpoint.resume_from = path
    with pytest.warns(UserWarning, match="not a torch generator state"):
        out = tppo.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["updates"] == 1
    loaded = load_checkpoint(path)
    tag, _ = tagent.build_agent((2,), False, cfg, space, agent_from_flax(loaded["agent"]), device="cpu")
    for name, p in tag.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), agent_from_flax(jax.device_get(params))[name].numpy())


def test_a_twinless_env_falls_back_with_one_event(tmp_path, monkeypatch):
    events = []
    monkeypatch.setattr(tppo, "fused_fallback", lambda reason, detail: events.append(reason))
    extra = ["env=dummy", "env.id=dummy_discrete", "algo.fused_rollout=True", "algo.total_steps=32"]
    out = _run(tmp_path, extra, "d")
    assert events == ["jittable_env"] and out["fused_rollout"] is False and out["updates"] == 1


@pytest.mark.parametrize(
    "override, item",
    [
        ("env.id=LunarLander-v3", "A1"),
        # the classic-control ids' pixels are drawn by the port now
        # (envs/render.py, test_ppo_trains_on_cartpole_pixels); those of an
        # id without a host env are not
        pytest.param("algo.cnn_keys.encoder=[rgb] env.id=LunarLander-v3", "A1", id="algo.cnn_keys.encoder=[rgb]-A1"),
    ],
)
def test_unported_options_raise_naming_their_roadmap_item(tmp_path, override, item):
    with pytest.raises(NotImplementedError, match=item):
        _run(tmp_path, override.split(), "u")


def test_ppo_trains_on_cartpole_pixels(tmp_path):
    """``algo.cnn_keys.encoder=[rgb]`` on the port's CartPole-v1: the
    frames (64x64) beside the state, through the CNN encoder."""
    out = _run(tmp_path, ["algo.cnn_keys.encoder=[rgb]"], "px")
    assert out["updates"] == 2 and all(np.isfinite(v) for v in out["metrics"].values())


def test_ppo_decoupled_raises_naming_a10():
    cfg = dotdict(compose("config", ["exp=ppo_decoupled", "fabric=cpu"]))
    with pytest.raises(NotImplementedError, match="A10"):
        cli.check_configs(cfg)


CLI = ["exp=ppo", "fabric=cpu", "dry_run=True", "env.capture_video=False", "env.backend=sync", "metric.telemetry.enabled=True"]


@pytest.mark.parametrize("fused", [False, True])
def test_cli_dry_run_checkpoints_resumes_and_evaluates(tmp_path, fused):
    """``python -m sheeprl_tpu_torch exp=ppo fabric=cpu dry_run=True`` (the
    CLI's ``run``): a checkpoint, a resume from it, ``cli_eval`` on it."""
    argv = CLI + [f"algo.fused_rollout={fused}", f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "ppo" / "CartPole-v1" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    assert load_checkpoint(ckpt)["update"] == 1
    cli.run(argv + [f"checkpoint.resume_from={ckpt}"])
    assert os.path.isdir(tmp_path / "ppo" / "CartPole-v1" / "cli" / "version_1")
    cli.evaluation([f"checkpoint_path={ckpt}"])


def test_cli_twinless_env_records_one_fused_fallback_event(tmp_path):
    argv = CLI + ["env=dummy", "env.id=dummy_discrete", "algo.fused_rollout=True", f"log_base_dir={tmp_path}", "run_name=d"]
    cli.run(argv)
    (path,) = glob.glob(str(tmp_path / "**" / "telemetry.jsonl"), recursive=True)
    events = [json.loads(line) for line in open(path)]
    fallbacks = [e for e in events if e["event"] == "fused_fallback"]
    assert [e["reason"] for e in fallbacks] == ["jittable_env"]
    assert events[-1]["fused_fallbacks"] == {"jittable_env": 1}
