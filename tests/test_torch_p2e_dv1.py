"""The port's Plan2Explore on Dreamer-V1 (sheeprl_tpu_torch/algos/p2e_dv1)
against the JAX package's, at tiny widths on the CPU.

Weights come from the JAX ``build_agent`` (the ensemble's vmapped tree
included), shifted by seeded numpy noise, and load into the port through
``p2e_dv2/convert.load_checkpoint_state``; inputs are made with numpy from
a seed. Both packages get Dreamer-V1's smooth sampler
(``tests/test_torch_dreamer_v1.py``: a fixed noise pattern for the
Gaussian state, the straight-through mode for actions), patched where each
looks it up, the JAX P2E module's own ``sample_actor_actions`` too. The
JAX step is jitted.

Tolerances, fp32 on the CPU: 1e-5 on the ensemble, the intrinsic reward
and a step's losses and values, 1e-4 on gradients and gradient norms, and
Adam's bound on updated params (``test_torch_p2e_dv2.check_step``). One
bf16 bound, stated where it applies: the intrinsic reward of bf16 members
at the config's multiplier of 10000.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv1 import agent as jp2e_agent
from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_exploration as jp2e
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as tdv1
from sheeprl_tpu_torch.algos.p2e_dv1 import agent as tagent
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as texpl
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning as tfine
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as tp2e_dv2
from sheeprl_tpu_torch.algos.p2e_dv2.agent import models_of
from sheeprl_tpu_torch.algos.p2e_dv2.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_dreamer_v1 import TINY, deterministic  # noqa: F401  (deterministic is a fixture)
from tests.test_torch_dreamer_v2 import _batch, _j_actions, obs_space
from tests.test_torch_dv3_train import _perturb, close, t
from tests.test_torch_p2e_dv2 import OPTS, check_step, cli_args, jax_tx, run_phases

TOL = 1e-5
GRAD_TOL = 1e-4
N_ENS = 3
TRAINED = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")
# bf16 members against bf16 members, relative to the largest reward: both
# packages round each Dense output to bf16 at the same points, so here they
# agree to the fp32 variance's rounding (1.2e-7 measured on the CPU);
# 2^-12 leaves room for a trunk output rounding to its other bf16
# neighbour (2^-8 of it). The multiplier (10000 in
# configs/algo/p2e_dv1.yaml) scales reward and error alike.
BF16_REL = 2.0**-12


def p2e_cfg(*extra, exp="p2e_dv1_exploration"):
    return dotdict(compose("config", [f"exp={exp}", "env=dummy", "env.id=dummy_discrete", *TINY, f"algo.ensembles.n={N_ENS}", *extra]))


@pytest.fixture()
def p2e_deterministic(deterministic, monkeypatch):
    monkeypatch.setattr(jp2e, "sample_actor_actions", _j_actions)


def jax_agent(cfg, actions_dim, is_continuous, space=None):
    """The JAX P2E-DV1 modules and their perturbed params by checkpoint key."""
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    wm, wp, actor, atp, critic, ctp, aep, cep, ens, ep, _ = jp2e_agent.build_agent(
        fabric, actions_dim, is_continuous, jdotdict(cfg.to_dict()), space or obs_space()
    )
    params = {k: _perturb(p, i) for i, (k, p) in enumerate(zip(TRAINED, (wp, atp, ctp, aep, cep, ep)))}
    return types.SimpleNamespace(wm=wm, actor=actor, critic=critic, ensemble=ens, params=params)


def port_agent(cfg, actions_dim, is_continuous, params):
    agent = tagent.build_agent(actions_dim, is_continuous, cfg, obs_space(), device="cpu")
    load_checkpoint_state(params, models_of(agent))
    return agent


# --------------------------------------------------------------------------- #
# the ensemble and the intrinsic reward
# --------------------------------------------------------------------------- #


def test_ensemble_predicts_the_embedding():
    """The stacked members against the JAX ``ensemble_apply``: their output
    is the encoder's width (``embedding_dim``), the ensemble loss is held on
    an embedding, and the intrinsic reward is the population variance."""
    cfg = p2e_cfg()
    j = jax_agent(cfg, (3,), False)
    agent = port_agent(cfg, (3,), False, j.params)
    ens = agent.ensembles
    assert ens.head.kernel.shape[-1] == agent.world_model.embedding_dim == jp2e_agent.embedding_dim(j.wm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 2, ens.linears[0].kernel.shape[1])).astype(np.float32)
    target = rng.standard_normal((3, 2, agent.world_model.embedding_dim)).astype(np.float32)
    want = jp2e_agent.ensemble_apply(j.ensemble, j.params["ensembles"], jnp.asarray(x))
    close(ens(t(x)), want, TOL)
    outs = want[:, :-1]
    jloss = -jd.Independent(jd.Normal(outs, jnp.ones_like(outs)), 1).log_prob(jnp.broadcast_to(jnp.asarray(target)[None], outs.shape)).mean(axis=(1, 2)).sum()
    close(tp2e_dv2.ensemble_loss(ens, t(x), t(target)), jloss, TOL)
    got = intrinsic_reward(ens, t(x[..., :-3]), t(x[..., -3:]), 10000.0)
    close(got / 10000.0, want.var(axis=0).mean(axis=-1, keepdims=True), TOL)


def test_intrinsic_reward_at_bf16_within_its_bound():
    """bf16 members (fp32 output Dense, as the JAX ``_dense(..., float32)``)
    in both packages from the same params and inputs, at the multiplier of
    ``configs/algo/p2e_dv1.yaml``: the rewards agree within ``BF16_REL`` of
    the largest one."""
    n, in_dim, units, out = 10, 24, 32, 16
    member = jp2e_agent.EnsembleDV1(output_dim=out, mlp_layers=2, dense_units=units, dtype=jnp.bfloat16)
    params = jp2e_agent.init_ensembles(member, n, jax.random.PRNGKey(0), jnp.zeros((1, in_dim)))
    ens = Ensemble(n, in_dim, out, 2, units, use_layer_norm=False, dtype=torch.bfloat16, eps=1e-5, act="elu")
    from sheeprl_tpu_torch.algos.p2e_dv3.convert import ensemble_from_flax

    ens.load_state_dict(ensemble_from_flax(params, "_MLPBlock_0"))
    x = np.random.default_rng(1).standard_normal((5, 8, in_dim)).astype(np.float32)
    multiplier = float(p2e_cfg().algo.intrinsic_reward_multiplier)
    assert multiplier == 10000.0
    want = np.asarray(jp2e_agent.ensemble_apply(member, params, jnp.asarray(x)).var(axis=0).mean(axis=-1, keepdims=True) * multiplier)
    got = intrinsic_reward(ens, t(x[..., :-3]), t(x[..., -3:]), multiplier).numpy()
    assert got.dtype == np.float32 and np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


# --------------------------------------------------------------------------- #
# one exploration step, the converter and the player
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "actions_dim, is_continuous, extra", [((3,), False, ()), ((2,), True, ("algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0.01"))]
)
def test_exploration_step_matches_jax(actions_dim, is_continuous, extra, p2e_deterministic):
    """One exploration step through both packages from the same weights and
    batch: the 22 metrics (``Rewards/intrinsic`` at the multiplier of
    10000 and ``Loss/ensemble_loss`` in embedding space among them), every
    model's gradients and updated params; both actors learn by dynamics
    backpropagation through imagination."""
    cfg = p2e_cfg(*extra)
    j = jax_agent(cfg, actions_dim, is_continuous)
    agent = port_agent(cfg, actions_dim, is_continuous, j.params)
    txs = {name: jax_tx(cfg, group) for name, _, group in OPTS}
    fabric = types.SimpleNamespace(data_axis="data", world_size=1)
    train = jp2e.make_train_fn(fabric, j.wm, j.actor, j.critic, j.ensemble, *txs.values(), jdotdict(cfg.to_dict()), is_continuous, actions_dim)
    p = j.params
    opt_states = [txs[n].init(p[k]) for n, k in zip(txs, TRAINED)]
    d = _batch(actions_dim, is_continuous)
    j_out = train(*(p[k] for k in TRAINED), *opt_states, {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0))
    j_new, j_opts, j_metrics = dict(zip(TRAINED, j_out[:6])), dict(zip(TRAINED, j_out[6:12])), j_out[12]

    opts = tp2e_dv2.build_optimizers(cfg, agent)
    step = texpl.make_train_step(agent, opts, cfg, is_continuous)
    grads = {}
    fused_gru.reset_launch_count()
    metrics = step({k: t(v) for k, v in d.items()}, None, grads)
    assert fused_gru.launch_count == 0
    assert texpl.METRIC_ORDER == jp2e.METRIC_ORDER and metrics.shape == (22,)
    for i, name in enumerate(texpl.METRIC_ORDER):
        close(metrics[i], np.asarray(j_metrics)[i], GRAD_TOL if name.startswith("Grads/") else TOL, name)
    assert float(metrics[texpl.METRIC_ORDER.index("Rewards/intrinsic")]) > 0
    check_step(agent, j_new, j_opts, grads, cfg)


def test_converter_round_trip_checkpoint_keys_and_the_player(deterministic, monkeypatch):
    """Every leaf of the JAX trees converts both ways and the checkpoint
    holds the JAX keys (no target critics); the player explores with the
    exploration actor (its step against the JAX world model's
    ``observe_step`` and the exploration actor) and resets per env."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import agent as dv2_agent
    from tests.test_torch_dreamer_v2 import _t_actions

    monkeypatch.setattr(dv2_agent, "sample_actor_actions", _t_actions)
    cfg = p2e_cfg()
    j = jax_agent(cfg, (3,), False)
    agent = port_agent(cfg, (3,), False, j.params)
    models = models_of(agent)
    state = checkpoint_state(models, tp2e_dv2.build_optimizers(cfg, agent))
    assert set(state) == set(TRAINED) | {k for _, k, _ in OPTS}
    for k, tree in j.params.items():
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), tree, state[k])
    player = agent.player
    assert player.actor is agent.actor_exploration
    rng = np.random.default_rng(4)
    obs = {"rgb": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8), "state": rng.standard_normal((2, 5)).astype(np.float32)}
    player.init_states()
    got = player.get_actions(obs)
    z, h = j.wm.apply(j.params["world_model"], jnp.zeros((2, 4)), jnp.zeros((2, 8)), jnp.zeros((2, 3)), obs, jax.random.PRNGKey(0), method="observe_step")
    close(got, _j_actions(j.actor, j.params["actor_exploration"], jnp.concatenate([z, h], -1), None), TOL)
    player.init_states([0])
    assert float(player.h[0].abs().sum()) == 0 and float(player.h[1].abs().sum()) > 0


# --------------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------------- #


def test_exploration_finetuning_and_eval_through_the_cli(tmp_path, monkeypatch):
    """``exp=p2e_dv1_exploration`` then ``exp=p2e_dv1_finetuning`` from its
    checkpoint through ``python -m sheeprl_tpu_torch`` on the CPU, and
    ``cli_eval`` of each: the JAX keys, the finetuning player on the
    exploration actor up to the first gradient step, then the task actor."""
    out, ckpt, fout, fckpt = run_phases(tmp_path, monkeypatch, "dv1", (texpl, tfine), cli_args(TINY))
    assert out["env_steps"] == 12 and out["gradient_steps"] > 0 and out["test_steps"] > 0
    assert list(out["metrics"]) == list(texpl.METRIC_ORDER) and all(np.isfinite(v) for v in out["metrics"].values())
    state = load_checkpoint(ckpt)
    assert {"critic_exploration", "ensembles", "ensemble_optimizer", "rb"} <= set(state) and "target_critic_task" not in state
    assert fout["switched_at"] == 4 + 2 and list(fout["metrics"]) == list(tdv1.METRIC_ORDER)
    fstate = load_checkpoint(fckpt)
    assert "ensembles" not in fstate and {"actor_task", "actor_exploration", "critic_task_optimizer"} <= set(fstate)


def test_exploration_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote resumes the port's exploration:
    the counters continue, the JAX keys reseed the streams with a warning,
    and with no gradient step after the resume the next checkpoint holds
    the JAX params and optimizer states."""
    argv = ["exp=p2e_dv1_exploration", *cli_args(TINY), "algo.total_steps=6", "algo.learning_starts=100", "buffer.size=64", f"log_base_dir={tmp_path}", "run_name=j"]
    cfg = dotdict(compose("config", argv))
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    j = jax_agent(cfg, (2,), False, space)
    state = dict(j.params)
    for (_, key, group), k in zip(OPTS, TRAINED):
        state[key] = jax_tx(cfg, group, record=False).init(j.params[k])
    key = jax.random.PRNGKey(0)
    state.update(ratio={"_ratio": 1.0, "_prev": 2, "_pretrain_steps": 1}, update=1, batch_size=2, last_log=0, last_checkpoint=2, rng_key=key, player_rng_key=key)
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, state)
    cfg.checkpoint.resume_from = path
    with pytest.warns(UserWarning, match="not a torch generator state"):
        out = texpl.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["env_steps"] == 6 and out["gradient_steps"] == 0
    saved = load_checkpoint(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))[-1])
    for k in ("world_model", "ensembles", "critic_exploration", "ensemble_optimizer"):
        for a, b in zip(jax.tree.leaves(state[k]), jax.tree.leaves(saved[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
