"""The port's Plan2Explore on Dreamer-V3 (sheeprl_tpu_torch.algos.p2e_dv3)
against the JAX package's, module by module and one whole exploration step.

Weights come from the JAX ``build_agent`` (the ensemble's vmapped tree
included), shifted by seeded numpy noise, and load into the port through
its checkpoint loader; inputs are made with numpy from a seed. Sizes are
``tests/test_torch_dv3_train.py::TINY`` with 3 ensemble members. The JAX
side is jitted single functions, never the JAX CLI.

Noise: both packages get the deterministic straight-through sampler of
``test_torch_dv3_train.py`` (patched where each looks it up, the JAX P2E
module's own ``sample_actor_actions`` too).

Tolerances, fp32 on the CPU: ``TOL`` 1e-5 on losses, values, rewards and
Moments, ``GRAD_TOL`` 1e-4 on gradients and gradient norms, and the Adam
bound of ``test_train_step_matches_jax`` on updated params.
"""

import glob
import json
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv3 import agent as jp2e_agent
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jp2e
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    actor_from_flax,
    critic_from_flax,
    world_model_from_flax,
)
from sheeprl_tpu_torch.algos.p2e_dv3 import agent as tagent
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as texpl
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as tfine
from sheeprl_tpu_torch.algos.p2e_dv3.convert import (
    checkpoint_state,
    ensemble_from_flax,
    ensemble_to_flax,
    load_checkpoint_state,
)
from sheeprl_tpu_torch.config.compose import _has_nested, compose as compose_tree, resolve
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict, set_nested
from tests.test_torch_dv3_train import (  # noqa: F401  (deterministic is a fixture)
    GRAD_TOL,
    TINY,
    TOL,
    _j_actions,
    _jax_tx,
    _perturb,
    _recording,
    batch,
    close,
    deterministic,
    obs_space,
    t,
)

N_ENS = 3


def p2e_cfg(env="dummy_discrete", exp="p2e_dv3_exploration", argv=(), **extra):
    """``exp`` (with the command-line ``argv``) at ``TINY`` widths with 3
    ensemble members, fp32, on the dummy env ``env``."""
    tree = compose_tree("config", [f"exp={exp}", "env=dummy", f"env.id={env}", *argv], interpolate=False)
    overrides = {
        **TINY,
        "fabric.precision": "32-true",
        "algo.cnn_keys.encoder": ["rgb"],
        "algo.mlp_keys.encoder": ["state"],
        "algo.ensembles.n": N_ENS,
        **extra,
    }
    for key, value in overrides.items():
        assert _has_nested(tree, key), key
        set_nested(tree, key, value)
    return dotdict(resolve(tree))


@pytest.fixture()
def p2e_deterministic(deterministic, monkeypatch):
    monkeypatch.setattr(jp2e, "sample_actor_actions", _j_actions)


def jax_agent(cfg, space, actions_dim, is_continuous):
    """The JAX P2E agent from its ``build_agent`` (fp32, CPU) with every
    param tree perturbed apart (targets apart from their critics)."""
    fabric = JaxFabric(devices=1, precision="fp32", accelerator="cpu")
    wm, wp, actor, atp, critic, ctp, _, aep, critics, ens, ep, _ = jp2e_agent.build_agent(
        fabric, actions_dim, is_continuous, cfg, space
    )
    params = {
        "world_model": _perturb(wp, 0),
        "actor_task": _perturb(atp, 1),
        "critic_task": _perturb(ctp, 2),
        "target_critic_task": _perturb(ctp, 3),
        "actor_exploration": _perturb(aep, 4),
        "ensembles": _perturb(ep, 5),
        "critics_exploration": {
            k: {"module": _perturb(c["params"], 6 + 2 * i), "target_module": _perturb(c["params"], 7 + 2 * i)}
            for i, (k, c) in enumerate(critics.items())
        },
    }
    meta = {k: {"weight": c["weight"], "reward_type": c["reward_type"]} for k, c in critics.items()}
    return types.SimpleNamespace(wm=wm, actor=actor, critic=critic, ensemble=ens, meta=meta, params=params)


def port_agent(cfg, space, actions_dim, is_continuous, params):
    agent = tagent.build_agent(actions_dim, is_continuous, cfg, space, device="cpu")
    load_checkpoint_state(params, agent)
    return agent


def jax_txs(cfg):
    algo = cfg["algo"]
    return {
        name: _recording(_jax_tx(algo[group]["optimizer"], algo[group]["clip_gradients"]))
        for name, group in (
            ("world", "world_model"),
            ("actor_task", "actor"),
            ("critic_task", "critic"),
            ("actor_expl", "actor"),
            ("critic_expl", "critic"),
            ("ensemble", "ensembles"),
        )
    }


# --------------------------------------------------------------------------- #
# the ensemble and the intrinsic reward
# --------------------------------------------------------------------------- #


def _ensemble_pair(seed=0):
    cfg = p2e_cfg()
    j = jax_agent(cfg, obs_space(("rgb",), ("state",)), (3,), False)
    ens = tagent.build_ensemble(cfg, tagent.build_agent((3,), False, cfg, obs_space(("rgb",), ("state",)), "cpu").world_model, (3,), torch.float32)
    ens.load_state_dict(ensemble_from_flax(j.params["ensembles"]))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 2, ens.linears[0].kernel.shape[1])).astype(np.float32)
    return j, ens, x


def test_ensemble_forward_and_loss_match():
    """The stacked module against the JAX ``ensemble_apply`` (vmap of one
    member) on the same inputs, and the ensemble loss on a posterior."""
    j, ens, x = _ensemble_pair()
    want = jp2e_agent.ensemble_apply(j.ensemble, j.params["ensembles"], jnp.asarray(x))
    got = ens(t(x))
    assert got.shape == (N_ENS, 4, 2, ens.head.kernel.shape[-1])
    close(got, want)
    s = j.wm.stoch_state_size
    zs, hs, actions = t(x[..., :s]), t(x[..., s:-3]), t(x[..., -3:])
    outs = want[:, :-1]
    jloss = -jd.MSEDistribution(outs, dims=1).log_prob(jnp.broadcast_to(jnp.asarray(x[1:, :, :s])[None], outs.shape)).mean(axis=(1, 2)).sum()
    close(texpl.ensemble_loss(ens, zs, hs, actions), jloss)


def test_intrinsic_reward_is_the_population_variance():
    """``jnp.var`` has ddof 0 where ``torch.var`` defaults to 1: the port's
    intrinsic reward equals the JAX expression, and not the n/(n-1) one."""
    j, ens, x = _ensemble_pair(1)
    traj, acts = t(x[..., :-3]), t(x[..., -3:])
    preds = jp2e_agent.ensemble_apply(j.ensemble, j.params["ensembles"], jnp.asarray(x))
    want = preds.var(axis=0).mean(axis=-1, keepdims=True) * 0.7
    got = texpl.intrinsic_reward(ens, traj, acts, 0.7)
    close(got, want)
    biased = ens(t(x)).var(0).mean(-1, keepdim=True) * 0.7
    np.testing.assert_allclose(biased.detach().numpy(), np.asarray(want) * N_ENS / (N_ENS - 1), rtol=1e-5)


# --------------------------------------------------------------------------- #
# one exploration step
# --------------------------------------------------------------------------- #


def _adam_bound(name, got, want, jg, lr):
    # Adam's first step is lr * g / (|g| + eps): 2 lr + 1e-6 everywhere and
    # 1e-6 where |g| > 1e-3 (test_torch_dv3_train.test_train_step_matches_jax)
    for k in want:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6, f"{name} param {k}"
        big = jg[k].abs() > 1e-3
        if big.any():
            assert float(diff[big].max()) <= 1e-6, f"{name} param {k} (|g| > 1e-3)"


@pytest.mark.parametrize(
    "actions_dim, is_continuous, env", [((3,), False, "dummy_discrete"), ((2,), True, "dummy_continuous")]
)
def test_exploration_step_matches_jax(actions_dim, is_continuous, env, p2e_deterministic):
    """One exploration step through both packages from the same weights and
    batch: every metric, every model's gradients (through a recording optax
    transformation), the updated params and every Moments. The port's
    recurrent step is the fused wrapper (its plain version on CPU
    tensors); with continuous actions both actors' gradients run back
    through imagination."""
    cfg = p2e_cfg(env)
    space = obs_space(("rgb",), ("state",))
    j = jax_agent(cfg, space, actions_dim, is_continuous)
    agent = port_agent(cfg, space, actions_dim, is_continuous, j.params)
    keys = tuple(j.meta)
    assert tuple(agent.critics_exploration) == keys == ("intrinsic", "extrinsic")
    txs = jax_txs(cfg)
    fabric = types.SimpleNamespace(data_axis="data", world_size=1, model_axis=None)
    train = jp2e.make_train_fn(
        fabric, j.wm, j.actor, j.critic, j.ensemble, j.meta, *txs.values(), jdotdict(cfg), is_continuous, actions_dim
    )
    p = j.params
    crit = {k: p["critics_exploration"][k]["module"] for k in keys}
    targets = {k: p["critics_exploration"][k]["target_module"] for k in keys}
    d = batch(("rgb",), ("state",), actions_dim, is_continuous, seed=13)
    out = train(
        p["world_model"], p["actor_task"], p["critic_task"], p["target_critic_task"], p["actor_exploration"], crit, targets,
        p["ensembles"], txs["world"].init(p["world_model"]), txs["actor_task"].init(p["actor_task"]),
        txs["critic_task"].init(p["critic_task"]), txs["actor_expl"].init(p["actor_exploration"]),
        {k: txs["critic_expl"].init(crit[k]) for k in keys}, txs["ensemble"].init(p["ensembles"]),
        jm.init_moments(), {k: jm.init_moments() for k in keys}, {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0),
    )  # fmt: skip
    j_wm, j_at, j_ct, j_ae, j_ce, j_ens, o_wm, o_at, o_ct, o_ae, o_ce, o_ens, j_mt, j_me, j_metrics = out

    opts = texpl.build_optimizers(cfg, agent)
    step = texpl.make_train_step(agent, opts, cfg, is_continuous)
    moments_task, moments_expl = tm.init_moments(), {k: tm.init_moments() for k in keys}
    grads = {}
    fused_gru.reset_launch_count()
    metrics = step(moments_task, moments_expl, {k: t(v) for k, v in d.items()}, None, grads)
    assert fused_gru.launch_count == 0  # CPU tensors: the plain version ran

    order = texpl.metric_order(keys)
    assert order == jp2e.metric_order(keys) and metrics.shape == (len(order),)
    for i, name in enumerate(order):
        close(metrics[i], np.asarray(j_metrics)[i], GRAD_TOL if name.startswith("Grads/") else TOL, name)
    for got, want in [(moments_task, j_mt)] + [(moments_expl[k], j_me[k]) for k in keys]:
        close(got.low, want.low)
        close(got.high, want.high)

    critics = agent.critics_exploration
    cases = [
        ("world_model", agent.world_model, world_model_from_flax, o_wm, j_wm, cfg.algo.world_model),
        ("ensembles", agent.ensembles, ensemble_from_flax, o_ens, j_ens, cfg.algo.ensembles),
        ("actor_exploration", agent.actor_exploration, actor_from_flax, o_ae, j_ae, cfg.algo.actor),
        ("actor_task", agent.actor_task, actor_from_flax, o_at, j_at, cfg.algo.actor),
        ("critic_task", agent.critic_task, critic_from_flax, o_ct, j_ct, cfg.algo.critic),
    ] + [
        (f"critic_exploration_{k}", critics[k]["critic"], critic_from_flax, o_ce[k], j_ce[k], cfg.algo.critic)
        for k in keys
    ]
    assert sorted(grads) == sorted(c[0] for c in cases)
    for name, module, from_flax, opt_state, new_params, group in cases:
        jg = from_flax(opt_state[1])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == jg.keys(), name
        for k in jg:
            close(got[k], jg[k], GRAD_TOL, f"{name} grad {k}")
        _adam_bound(name, module.state_dict(), from_flax(new_params), jg, group.optimizer.lr)


def test_exploration_targets_refresh_by_ema():
    cfg = p2e_cfg()
    agent = tagent.build_agent((3,), False, cfg, obs_space(("rgb",), ("state",)), "cpu")
    pairs = [(agent.critic_task, agent.target_critic_task)] + [(c["critic"], c["target"]) for c in agent.critics_exploration.values()]
    with torch.no_grad():
        for _, target in pairs:
            for p in target.parameters():
                p.add_(1.0)
    before = [[p.clone() for p in target.parameters()] for _, target in pairs]
    texpl.refresh_targets(agent, 0.25)
    for (critic, target), old in zip(pairs, before):
        for c, b, a in zip(critic.parameters(), old, target.parameters()):
            torch.testing.assert_close(a, 0.25 * c + 0.75 * b)


# --------------------------------------------------------------------------- #
# the converter and the checkpoint
# --------------------------------------------------------------------------- #


def _flat_shapes(tree, prefix=""):
    """{path: (type name, shape)} of a checkpoint tree: dicts by key,
    named tuples by field, tuples by index."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        out = {prefix: (type(tree).__name__ if hasattr(tree, "_fields") else "tuple", None)}
        for f, v in zip(fields, tree):
            out.update(_flat_shapes(v, f"{prefix}/{f}"))
        return out
    return {prefix: ("leaf", tuple(np.shape(tree)))}


def jax_checkpoint(cfg, j):
    """The exploration checkpoint the JAX ``main`` writes (JAX
    ``p2e_dv3_exploration.py`` :901-936) over ``j``'s params, with its
    optimizer inits."""
    algo, p = cfg["algo"], j.params
    tx = {g: _jax_tx(algo[g]["optimizer"], algo[g]["clip_gradients"]) for g in ("world_model", "actor", "critic", "ensembles")}
    state = {
        **{k: p[k] for k in ("world_model", "actor_task", "critic_task", "target_critic_task", "ensembles", "actor_exploration")},
        "world_optimizer": tx["world_model"].init(p["world_model"]),
        "actor_task_optimizer": tx["actor"].init(p["actor_task"]),
        "critic_task_optimizer": tx["critic"].init(p["critic_task"]),
        "ensemble_optimizer": tx["ensembles"].init(p["ensembles"]),
        "actor_exploration_optimizer": tx["actor"].init(p["actor_exploration"]),
        "moments_task": {"low": np.asarray(0.5, np.float32), "high": np.asarray(2.0, np.float32)},
        "critics_exploration": p["critics_exploration"],
        "ratio": {"_ratio": 1.0, "_prev": 12, "_pretrain_steps": 0},
        "update": 6,
        "batch_size": 2,
        "last_log": 12,
        "last_checkpoint": 12,
        "rng_key": np.asarray(jax.random.PRNGKey(3)),
        "player_rng_key": np.asarray(jax.random.PRNGKey(4)),
    }
    for k in j.meta:
        state[f"critic_exploration_optimizer_{k}"] = tx["critic"].init(p["critics_exploration"][k]["module"])
        state[f"moments_exploration_{k}"] = {"low": np.asarray(0.1, np.float32), "high": np.asarray(0.3, np.float32)}
    return jax.tree.map(np.asarray, state)


def test_checkpoint_has_the_jax_keys_and_shapes():
    """The port's exploration checkpoint has exactly the keys and leaf
    shapes of the JAX ``main``'s over the JAX ``build_agent`` and optimizer
    inits; loading the JAX one and writing it back gives it again."""
    cfg = p2e_cfg()
    space = obs_space(("rgb",), ("state",))
    j = jax_agent(cfg, space, (3,), False)
    want = jax_checkpoint(cfg, j)
    agent = tagent.build_agent((3,), False, cfg, space, "cpu")
    opts = texpl.build_optimizers(cfg, agent)
    mt, me = tm.init_moments(), {k: tm.init_moments() for k in agent.critics_exploration}
    got = checkpoint_state(agent, opts, mt, me)
    counters = {"ratio", "update", "batch_size", "last_log", "last_checkpoint", "rng_key", "player_rng_key"}
    assert set(got) | counters == set(want)
    for k in got:
        assert _flat_shapes(got[k]) == _flat_shapes(want[k]), k
    load_checkpoint_state(want, agent, opts, mt, me)
    back = checkpoint_state(agent, opts, mt, me)
    for k in back:
        np.testing.assert_equal(jax.tree.leaves(back[k]), jax.tree.leaves(want[k]), err_msg=k)
    assert (float(mt.low), float(me["extrinsic"].high)) == (0.5, np.float32(0.3))


def test_ensemble_converter_round_trip_with_nothing_left_unported():
    cfg = p2e_cfg()
    j = jax_agent(cfg, obs_space(("rgb",), ("state",)), (3,), False)
    tree = j.params["ensembles"]
    sd = ensemble_from_flax(tree)
    assert set(sd) == {"linears.0.kernel", "linears.0.bias", "norms.0.scale", "norms.0.bias", "head.kernel", "head.bias"}
    back = ensemble_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="no port counterpart"):
        ensemble_from_flax({"params": {**tree["params"], "Dense_9": {"kernel": np.zeros((3, 1, 1))}}})
    with pytest.raises(KeyError, match="no flax counterpart"):
        ensemble_to_flax({**sd, "extra.weight": torch.zeros(1)})


def test_build_agent_skips_zero_weights_and_needs_an_intrinsic_critic():
    space = obs_space(("rgb",), ("state",))
    agent = tagent.build_agent((3,), False, p2e_cfg(**{"algo.critics_exploration.extrinsic.weight": 0.0}), space, "cpu")
    assert tuple(agent.critics_exploration) == ("intrinsic",) and agent.player.actor is agent.actor_exploration
    with pytest.raises(RuntimeError, match="intrinsic critic"):
        tagent.build_agent((3,), False, p2e_cfg(**{"algo.critics_exploration.intrinsic.reward_type": "task"}), space, "cpu")
    agent = tagent.build_agent((3,), False, p2e_cfg(**{"algo.player.actor_type": "task"}), space, "cpu")
    assert agent.player.actor is agent.actor_task


# --------------------------------------------------------------------------- #
# the loops, the CLI and cli_eval
# --------------------------------------------------------------------------- #

LOOP = {"env.num_envs": 2, "buffer.size": 64, "algo.learning_starts": 8, "algo.total_steps": 24, "env.backend": "sync", "buffer.memmap": False}


def _argv(tmp_path, exp, run_name, *extra):
    argv = [f"exp={exp}", "env=dummy", "env.id=dummy_discrete", "fabric=cpu", "env.capture_video=False"]
    argv += [f"{k}={json.dumps(v) if isinstance(v, list) else v}" for k, v in {**TINY, **LOOP}.items()]
    argv += ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", f"algo.ensembles.n={N_ENS}"]
    return argv + [f"log_base_dir={tmp_path}", f"run_name={run_name}", "metric.log_every=8", *extra]


def test_exploration_then_finetuning_then_eval_on_the_cpu(tmp_path):
    """Exploration through ``main`` (its buffer in the checkpoint),
    finetuning from its checkpoint (the exploration config read beside it,
    the buffer loaded from it), each with its test episode, and
    ``cli_eval`` on both checkpoints; B1 is never launched on the CPU."""
    fused_gru.reset_launch_count()
    cfg = p2e_cfg(**LOOP, log_base_dir=str(tmp_path), run_name="expl", **{"buffer.checkpoint": True})
    out = texpl.main(cfg, device="cpu")
    # 12 updates of 2 envs, training from update 4: Ratio(1) gives 1 step,
    # then one per env step
    assert out["env_steps"] == 24 and out["gradient_steps"] == 1 + 2 * 8
    assert list(out["metrics"]) == list(texpl.metric_order(("intrinsic", "extrinsic")))
    assert all(np.isfinite(v) for v in out["metrics"].values()) and out["test_steps"] > 0
    (ckpt,) = glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))
    assert {"critics_exploration", "ensembles", "moments_exploration_intrinsic", "rb"} <= set(load_checkpoint(ckpt))

    # the finetuning replay starts from the exploration run's
    fine = {**LOOP, "log_base_dir": str(tmp_path), "run_name": "fine", "buffer.load_from_exploration": True}
    fcfg = p2e_cfg("dummy_discrete", "p2e_dv3_finetuning", [f"checkpoint.exploration_ckpt_path={ckpt}"], **fine)
    fout = tfine.main(fcfg, exploration_cfg=tfine.exploration_config(fcfg), device="cpu")
    # the exploration actor takes the steps up to the first gradient step
    # (update 4, policy step 8), the task actor every later one
    assert fout["switched_at"] == 10 and fout["gradient_steps"] == 17
    assert list(fout["metrics"]) == list(texpl.dv3.METRIC_ORDER) and fout["test_steps"] > 0
    (fckpt,) = glob.glob(os.path.join(fout["log_dir"], "checkpoint", "*.ckpt"))
    fstate = load_checkpoint(fckpt)
    assert "ensembles" not in fstate and {"actor_task", "actor_exploration", "moments_task"} <= set(fstate)
    for path in (ckpt, fckpt):
        cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu"])
    assert fused_gru.launch_count == 0


def test_finetuning_through_the_cli_takes_the_exploration_config(tmp_path, monkeypatch):
    """``cli.run``'s finetuning path reads the exploration run's
    ``config.yaml`` with the port's reader, forces its env keys, refuses
    another env id, and passes ``exploration_cfg`` to the entry point."""
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(tmp_path / "RUNS.jsonl"))
    cli.run(_argv(tmp_path, "p2e_dv3_exploration", "expl", "env.action_repeat=2"))
    (ckpt,) = glob.glob(str(tmp_path / "p2e_dv3_exploration" / "dummy_discrete" / "expl" / "version_0" / "checkpoint" / "*.ckpt"))
    seen = {}
    real_main = tfine.main
    monkeypatch.setattr(tfine, "main", lambda fabric, cfg, **kw: seen.update(cfg=cfg, **kw) or real_main(fabric, cfg, **kw))
    cli.run(_argv(tmp_path, "p2e_dv3_finetuning", "fine", f"checkpoint.exploration_ckpt_path={ckpt}", "algo.horizon=2"))
    assert seen["exploration_cfg"]["algo"]["name"] == "p2e_dv3_exploration"
    # env.action_repeat forced from the exploration run, algo.horizon by main
    assert seen["cfg"]["env"]["action_repeat"] == 2 and seen["cfg"]["algo"]["horizon"] == 3
    records = [json.loads(line) for line in (tmp_path / "RUNS.jsonl").read_text().splitlines()]
    assert [(r["algo"], r["outcome"]) for r in records] == [("p2e_dv3_exploration", "completed"), ("p2e_dv3_finetuning", "completed")]
    with pytest.raises(ValueError, match="different environment"):
        cli.run(_argv(tmp_path, "p2e_dv3_finetuning", "other", f"checkpoint.exploration_ckpt_path={ckpt}").__add__(["env.id=dummy_continuous"]))


def test_exploration_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its ``save_checkpoint``) resumes
    the port's exploration: the counters continue, the JAX RNG keys reseed
    the streams with a warning, and with no gradient step after the resume
    the last checkpoint holds the JAX params."""
    cfg = p2e_cfg(**{**LOOP, "algo.total_steps": 16}, log_base_dir=str(tmp_path), run_name="resume")
    env = make_env(cfg, 0, 0, None, "test")()
    space, (actions_dim, is_continuous) = env.observation_space, action_dims(env.action_space)
    env.close()
    j = jax_agent(cfg, space, actions_dim, is_continuous)
    path = str(tmp_path / "jax" / "ckpt_12_0.ckpt")
    jax_save_checkpoint(path, jax_checkpoint(cfg, j))
    cfg.checkpoint.resume_from = path
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = texpl.main(cfg, device="cpu")
    assert any("not a torch generator state" in str(w.message) for w in caught)
    # updates 7 and 8; learning starts 4 + 7 (no buffer in the checkpoint)
    assert out["start_update"] == 7 and out["env_steps"] == 16 and out["gradient_steps"] == 0
    saved = load_checkpoint(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))[-1])
    for k in ("world_model", "ensembles", "actor_exploration"):
        for a, b in zip(jax.tree.leaves(saved[k]), jax.tree.leaves(j.params[k])):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert saved["update"] == 8 and float(saved["moments_exploration_intrinsic"]["high"]) == np.float32(0.3)
