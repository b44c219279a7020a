"""The port's Plan2Explore on Dreamer-V2 (sheeprl_tpu_torch/algos/p2e_dv2 and
the ``act`` of p2e_dv3's stacked ``Ensemble``) against the JAX package's,
at tiny widths on the CPU.

Weights come from the JAX ``build_agent`` (the ensemble's vmapped tree
included), shifted by seeded numpy noise, every target apart from its
critic, and load into the port through ``convert.load_checkpoint_state``;
inputs are made with numpy from a seed. Both packages get Dreamer-V2's
deterministic straight-through sampler (``tests/test_torch_dreamer_v2.py``),
patched where each looks it up, the JAX P2E module's own
``sample_actor_actions`` too. The JAX step is jitted.

Tolerances, fp32 on the CPU: 1e-5 on the ensemble, the intrinsic reward
and a step's losses and values, 1e-4 on gradients and gradient norms, and
the Adam bound of ``test_torch_dreamer_v2.py`` on updated params.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv2 import agent as jp2e_agent
from sheeprl_tpu.algos.p2e_dv2 import p2e_dv2_exploration as jp2e
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops.optim import adam as j_adam
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as tdv2
from sheeprl_tpu_torch.algos.p2e_dv2 import agent as tagent
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as texpl
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as tfine
from sheeprl_tpu_torch.algos.p2e_dv2.convert import checkpoint_state, converters, load_checkpoint_state
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_dreamer_v2 import TINY, _batch, _j_actions, deterministic, obs_space  # noqa: F401  (deterministic is a fixture)
from tests.test_torch_dv3_train import _perturb, _recording, close, t

TOL = 1e-5
GRAD_TOL = 1e-4
N_ENS = 3
# the JAX step's optimizers, in its argument order: (name, checkpoint key, config group)
OPTS = (
    ("world", "world_optimizer", "world_model"),
    ("actor_task", "actor_task_optimizer", "actor"),
    ("critic_task", "critic_task_optimizer", "critic"),
    ("actor_expl", "actor_exploration_optimizer", "actor"),
    ("critic_expl", "critic_exploration_optimizer", "critic"),
    ("ensemble", "ensemble_optimizer", "ensembles"),
)


def p2e_cfg(*extra, exp="p2e_dv2_exploration"):
    return dotdict(compose("config", [f"exp={exp}", "env=dummy", "env.id=dummy_discrete", *TINY, f"algo.ensembles.n={N_ENS}", *extra]))


@pytest.fixture()
def p2e_deterministic(deterministic, monkeypatch):
    monkeypatch.setattr(jp2e, "sample_actor_actions", _j_actions)


def jax_tx(cfg, group, record=True):
    o = cfg["algo"][group]["optimizer"]
    tx = j_adam(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"], weight_decay=o["weight_decay"], max_grad_norm=cfg["algo"][group]["clip_gradients"])
    return _recording(tx) if record else tx


def jax_agent(cfg, actions_dim, is_continuous, space=None):
    """The JAX P2E-DV2 modules and their perturbed params by checkpoint key."""
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    wm, wp, actor, atp, critic, ctp, _, aep, cep, _, ens, ep, _ = jp2e_agent.build_agent(
        fabric, actions_dim, is_continuous, jdotdict(cfg.to_dict()), space or obs_space()
    )
    params = {
        "world_model": _perturb(wp, 0),
        "actor_task": _perturb(atp, 1),
        "critic_task": _perturb(ctp, 2),
        "target_critic_task": _perturb(ctp, 3),
        "actor_exploration": _perturb(aep, 4),
        "critic_exploration": _perturb(cep, 5),
        "target_critic_exploration": _perturb(cep, 6),
        "ensembles": _perturb(ep, 7),
    }
    return types.SimpleNamespace(wm=wm, actor=actor, critic=critic, ensemble=ens, params=params)


def port_agent(cfg, actions_dim, is_continuous, params):
    agent = tagent.build_agent(actions_dim, is_continuous, cfg, obs_space(), device="cpu")
    load_checkpoint_state(params, tagent.models_of(agent))
    return agent


def check_step(agent, j_new, j_opts, grads, cfg):
    """Every model's gradients against the JAX ones (the recording
    transformation's state) and its updated params within Adam's bound:
    one step moves a param by about lr, so where ``|g|`` is near eps a
    gradient within 1e-4 may move it by up to lr; 1e-6 where ``|g| >
    1e-3``."""
    groups = {"world_model": "world_model", "ensembles": "ensembles", "actor_exploration": "actor", "critic_exploration": "critic", "actor_task": "actor", "critic_task": "critic"}
    for name, group in groups.items():
        module = getattr(agent, name)
        from_flax = converters(name, module)[1]
        want = from_flax(j_opts[name][1])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == want.keys(), name
        for k in want:
            close(got[k], want[k], GRAD_TOL, f"{name} grad {k}")
        lr = cfg["algo"][group]["optimizer"]["lr"]
        for k, w in from_flax(j_new[name]).items():
            diff = (module.state_dict()[k] - w).abs()
            assert float(diff.max()) <= 2 * lr + 1e-6, f"{name} param {k}"
            big = want[k].abs() > 1e-3
            if big.any():
                assert float(diff[big].max()) <= 1e-6, f"{name} param {k} (|g| > 1e-3)"


# --------------------------------------------------------------------------- #
# the ensemble and the intrinsic reward
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("layer_norm", [False, True])
def test_ensemble_forward_loss_and_intrinsic_reward_match(layer_norm):
    """The stacked ELU members (LayerNorm with eps 1e-5 when asked) against
    the JAX ``ensemble_apply`` (vmap of one member), the ensemble loss on a
    posterior, and the intrinsic reward: ``jnp.var`` has ddof 0 where
    ``torch.var`` defaults to 1."""
    cfg = p2e_cfg(f"algo.layer_norm={layer_norm}")
    j = jax_agent(cfg, (3,), False)
    agent = port_agent(cfg, (3,), False, j.params)
    ens = agent.ensembles
    assert len(ens.norms) == (1 if layer_norm else 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 2, ens.linears[0].kernel.shape[1])).astype(np.float32)
    want = jp2e_agent.ensemble_apply(j.ensemble, j.params["ensembles"], jnp.asarray(x))
    close(ens(t(x)), want, TOL)
    s = j.wm.stoch_state_size
    target = x[1:, :, :s]
    outs = want[:, :-1]
    jloss = -jd.Independent(jd.Normal(outs, jnp.ones_like(outs)), 1).log_prob(jnp.broadcast_to(target[None], outs.shape)).mean(axis=(1, 2)).sum()
    close(texpl.ensemble_loss(ens, t(x), t(target)), jloss, TOL)
    got = intrinsic_reward(ens, t(x[..., :-3]), t(x[..., -3:]), 0.7)
    close(got, want.var(axis=0).mean(axis=-1, keepdims=True) * 0.7, TOL)
    np.testing.assert_allclose(
        (ens(t(x)).var(0).mean(-1, keepdim=True) * 0.7).detach().numpy(), np.asarray(got) * N_ENS / (N_ENS - 1), rtol=1e-5
    )


# --------------------------------------------------------------------------- #
# one exploration step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "actions_dim, is_continuous, extra", [((3,), False, ()), ((2,), True, ("algo.world_model.use_continues=True", "algo.intrinsic_reward_multiplier=3"))]
)
def test_exploration_step_matches_jax(actions_dim, is_continuous, extra, p2e_deterministic):
    """One exploration step through both packages from the same weights and
    batch: the 22 metrics (``Rewards/intrinsic`` and ``Loss/ensemble_loss``
    among them), every model's gradients and updated params. Discrete
    actions learn by REINFORCE, continuous ones (with a continue model) by
    dynamics backpropagation through imagination."""
    cfg = p2e_cfg(*extra)
    j = jax_agent(cfg, actions_dim, is_continuous)
    agent = port_agent(cfg, actions_dim, is_continuous, j.params)
    txs = {name: jax_tx(cfg, group) for name, _, group in OPTS}
    fabric = types.SimpleNamespace(data_axis="data", world_size=1)
    train = jp2e.make_train_fn(fabric, j.wm, j.actor, j.critic, j.ensemble, *txs.values(), jdotdict(cfg.to_dict()), is_continuous, actions_dim)
    p = j.params
    order = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "critic_exploration", "target_critic_exploration", "ensembles")
    trained = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")
    opt_states = [txs[n].init(p[k]) for n, k in zip(txs, trained)]
    d = _batch(actions_dim, is_continuous)
    j_out = train(*(p[k] for k in order), *opt_states, {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0))
    j_new, j_opts, j_metrics = dict(zip(trained, j_out[:6])), dict(zip(trained, j_out[6:12])), j_out[12]

    opts = texpl.build_optimizers(cfg, agent)
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


def test_target_critics_are_hard_copies_every_freq_steps():
    """``refresh_targets`` copies both critics into their targets bit for
    bit; ``ReplayTrainer`` calls it before the steps 0, freq, 2 freq (the
    JAX ``cumulative % freq == 0``, :515)."""
    cfg = p2e_cfg("algo.critic.per_rank_target_network_update_freq=2")
    agent = tagent.build_agent((3,), False, cfg, obs_space(), device="cpu")
    with torch.no_grad():
        for m in (agent.target_critic_task, agent.target_critic_exploration):
            for p in m.parameters():
                p.add_(1.0)
    texpl.refresh_targets(agent)
    for c, g in ((agent.critic_task, agent.target_critic_task), (agent.critic_exploration, agent.target_critic_exploration)):
        for a, b in zip(c.parameters(), g.parameters()):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
        assert not any(q.requires_grad for q in g.parameters())
    refreshed = []
    trainer = tdv2.ReplayTrainer(cfg, None, 1, None, lambda tau: refreshed.append(tau), torch.device("cpu"))
    trainer.fn = lambda: torch.zeros(22)
    trainer.prefetcher = types.SimpleNamespace(sampled_batches=lambda n: range(n))
    trainer.window(5)
    assert trainer.steps == 5 and len(refreshed) == 3


def test_converter_round_trip_and_checkpoint_keys():
    """Every leaf of the JAX trees (the stacked ensemble and the targets
    included) converts both ways; the checkpoint holds the JAX keys; the
    player explores with the exploration actor."""
    cfg = p2e_cfg()
    j = jax_agent(cfg, (3,), False)
    agent = port_agent(cfg, (3,), False, j.params)
    assert agent.player.actor is agent.actor_exploration
    models = tagent.models_of(agent)
    opts = texpl.build_optimizers(cfg, agent)
    state = checkpoint_state(models, opts)
    assert set(state) == set(j.params) | {k for _, k, _ in OPTS}
    for k, tree in j.params.items():
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), tree, state[k])
    assert state["ensembles"]["params"]["_MLPBlock_0"]["Dense_0"]["kernel"].shape[0] == N_ENS
    again = port_agent(cfg, (3,), False, state)
    load_checkpoint_state(state, tagent.models_of(again), texpl.build_optimizers(cfg, again))
    for k, m in tagent.models_of(again).items():
        for (n, a), b in zip(m.state_dict().items(), models[k].state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{k} {n}")


# --------------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------------- #


def cli_args(tiny):
    """The CPU CLI runs' arguments at ``tiny`` widths: windows of 2 (the
    ensemble learns from the step after; 1 gives it none)."""
    argv = ["env=dummy", "env.id=dummy_discrete", "fabric=cpu", "env.capture_video=False", "env.backend=sync", "buffer.memmap=False", f"algo.ensembles.n={N_ENS}"]
    argv += [a for a in tiny if not a.startswith("algo.per_rank_sequence_length")]
    return argv + ["algo.per_rank_sequence_length=2", "algo.replay_ratio=1", "algo.per_rank_pretrain_steps=1", "algo.run_test=True"]


CLI = cli_args(TINY)
LOOP = ["algo.total_steps=12", "algo.learning_starts=4", "buffer.size=64", "buffer.checkpoint=True"]


def run_phases(tmp_path, monkeypatch, family, pkg, cli_args):
    """Exploration through ``cli.run`` (its buffer in the checkpoint), a
    resume of it through ``main``, finetuning through ``cli.run`` from its
    checkpoint with the buffer loaded from it, then ``cli_eval`` on both
    checkpoints; B1 is never launched. Returns both runs' reports and
    checkpoints."""
    expl, fine = pkg
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(tmp_path / "RUNS.jsonl"))
    seen = {}
    fused_gru.reset_launch_count()
    base = cli_args + LOOP + [f"log_base_dir={tmp_path}"]
    with monkeypatch.context() as m:
        for module, key in ((expl, "expl"), (fine, "fine")):
            m.setattr(module, "main", lambda fabric, cfg, real=module.main, key=key, **kw: seen.update({key: real(fabric, cfg, **kw)}))
        cli.run([f"exp=p2e_{family}_exploration", "run_name=expl", *base])
        (ckpt,) = glob.glob(os.path.join(seen["expl"]["log_dir"], "checkpoint", "*.ckpt"))
        cli.run([f"exp=p2e_{family}_finetuning", "run_name=fine", f"checkpoint.exploration_ckpt_path={ckpt}", "buffer.load_from_exploration=True", *base])
    (fckpt,) = glob.glob(os.path.join(seen["fine"]["log_dir"], "checkpoint", "*.ckpt"))
    for path in (ckpt, fckpt):
        cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu"])
    assert fused_gru.launch_count == 0
    return seen["expl"], ckpt, seen["fine"], fckpt


def test_exploration_finetuning_and_eval_through_the_cli(tmp_path, monkeypatch):
    """``exp=p2e_dv2_exploration`` then ``exp=p2e_dv2_finetuning`` from its
    checkpoint through ``python -m sheeprl_tpu_torch`` on the CPU, and
    ``cli_eval`` of each: the JAX keys in each checkpoint, the finetuning
    player on the exploration actor up to the first gradient step and on
    the task actor after it, and the exploration resumed from its own
    checkpoint."""
    out, ckpt, fout, fckpt = run_phases(tmp_path, monkeypatch, "dv2", (texpl, tfine), CLI)
    # 6 updates of 2 envs, training from update 2 (learning starts 4)
    assert out["env_steps"] == 12 and out["gradient_steps"] > 0 and out["test_steps"] > 0
    assert list(out["metrics"]) == list(texpl.METRIC_ORDER) and all(np.isfinite(v) for v in out["metrics"].values())
    assert {"target_critic_exploration", "ensembles", "ensemble_optimizer", "rb"} <= set(load_checkpoint(ckpt))
    assert fout["switched_at"] == 4 + 2 and list(fout["metrics"]) == list(tdv2.METRIC_ORDER)
    fstate = load_checkpoint(fckpt)
    assert "ensembles" not in fstate and {"actor_task", "target_critic_task", "actor_exploration", "critic_task_optimizer"} <= set(fstate)
    cfg = dotdict(compose("config", ["exp=p2e_dv2_exploration", *CLI, *LOOP, "algo.total_steps=16", f"log_base_dir={tmp_path}", "run_name=again", f"checkpoint.resume_from={ckpt}"]))
    again = texpl.main(cfg, device="cpu")
    assert again["start_update"] == 7 and again["env_steps"] == 16 and again["gradient_steps"] > 0


def test_exploration_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote resumes the port's exploration:
    the counters continue, the JAX keys reseed the streams with a warning,
    and with no gradient step after the resume the next checkpoint holds
    the JAX params and optimizer states."""
    cfg = dotdict(compose("config", ["exp=p2e_dv2_exploration", *CLI, "algo.total_steps=6", "algo.learning_starts=100", "buffer.size=64", f"log_base_dir={tmp_path}", "run_name=j"]))
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    j = jax_agent(cfg, (2,), False, space)
    trained = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")
    state = dict(j.params)
    for (_, key, group), k in zip(OPTS, trained):
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
    for k in ("world_model", "ensembles", "target_critic_exploration", "ensemble_optimizer"):
        for a, b in zip(jax.tree.leaves(state[k]), jax.tree.leaves(saved[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
