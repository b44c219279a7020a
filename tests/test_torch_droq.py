"""DroQ in the port against the JAX package on the CPU: the dropout and
LayerNorm critic ensemble, one update (three critic steps with the target
EMA after each, then the actor and alpha step against the ensemble's mean)
against the JAX ``make_train_fn``, and ``python -m sheeprl_tpu_torch
exp=droq`` on both replay paths with ``cli_eval``.

Both packages take the same dropout masks and Gaussian noise, in the order
each step draws them: the JAX side has its vmapped ensemble replaced by a
loop over the critics (the same ``critic.apply`` calls, one member at a
time, so that each member takes its own mask) and ``jax.random.bernoulli``
and ``normal`` patched, and runs one jitted step a call, traced afresh each
time (the draws are constants of its trace); the port has
``agent._uniform`` and ``_normal_noise`` patched.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.droq import agent as jdroq_agent
from sheeprl_tpu.algos.droq import droq as jdroq
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.droq import agent as tdroq_agent
from sheeprl_tpu_torch.algos.droq import droq as tdroq
from sheeprl_tpu_torch.algos.sac import agent as tagent
from sheeprl_tpu_torch.algos.sac.convert import from_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_sac import ACT_DIM, BATCH, FWD_TOL, OBS_DIM, PARAM_TOL, _batch, close, inject_noise, jax_pair, sac_cfg, t

HIDDEN, N = 16, 2


def droq_cfg():
    cfg = sac_cfg()
    cfg["algo"]["critic"]["dropout"] = 0.25
    return cfg


def make_masks(n_calls, seed=7):
    """``[call][critic][layer]`` keep masks ``[B, HIDDEN]``."""
    rng = np.random.default_rng(seed)
    return [[[rng.uniform(size=(BATCH, HIDDEN)) < 0.75 for _ in range(2)] for _ in range(N)] for _ in range(n_calls)]


def inject_masks(monkeypatch, masks):
    """The JAX ensemble as a loop over the critics drawing ``masks`` in
    (call, critic, layer) order; the port drawing them as (call, layer)
    ``[n, B, H]`` uniforms that are below the keep probability where kept."""
    j = [m for call in masks for critic in call for m in critic]
    p = [np.stack([call[i][layer] for i in range(N)]) for call in masks for layer in range(2)]

    def ensemble(critic, stacked, obs, action, key, n_critics):
        keys = jax.random.split(key, n_critics)
        qs = [
            critic.apply(jax.tree.map(lambda x: x[i], stacked), obs, action, deterministic=False, rngs={"dropout": keys[i]})
            for i in range(n_critics)
        ]
        return jnp.concatenate(qs, -1)

    monkeypatch.setattr(jdroq, "_ensemble_apply_dropout", ensemble)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(j.pop(0)))
    monkeypatch.setattr(tagent, "_uniform", lambda gen, shape, device: torch.from_numpy(np.where(p.pop(0), 0.0, 0.999).astype(np.float32)).reshape(shape))


def _pair_at(cfg):
    return jax_pair(cfg, jbuild=jdroq_agent.build_agent, tbuild=tdroq_agent.build_agent)


def _pair():
    return _pair_at(droq_cfg())


def test_dropout_critic_matches_jax(monkeypatch):
    jag, tag, _ = _pair()
    assert tag.critic.layer_norm and tag.critic.dropout == 0.25
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((BATCH, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-2, 2, (BATCH, ACT_DIM)).astype(np.float32)
    # no generator: deterministic, LayerNorm only
    want = jdroq_agent.critic_ensemble_apply(jag.critic, jag.critic_params, obs, act)
    close(tag.critic(t(obs), t(act)), want, FWD_TOL, "deterministic")
    inject_masks(monkeypatch, make_masks(1))
    want = jdroq._ensemble_apply_dropout(jag.critic, jag.critic_params, obs, act, jax.random.PRNGKey(0), N)
    close(tag.critic(t(obs), t(act), torch.Generator()), want, FWD_TOL, "dropout")


def test_an_update_of_three_critic_steps_and_the_actor_matches_jax(monkeypatch):
    g = 3
    cfg = droq_cfg()
    jag, tag, _ = _pair()
    batch = _batch(g, seed=3)
    actor_obs = np.random.default_rng(4).standard_normal((BATCH, OBS_DIM)).astype(np.float32)
    rng = np.random.default_rng(11)
    # per critic step: the next actions; then the actor's sample
    inject_noise(monkeypatch, [rng.standard_normal((BATCH, ACT_DIM)).astype(np.float32) for _ in range(g + 1)])
    # per critic step: the target's and the online ensemble's masks; then the actor's
    inject_masks(monkeypatch, make_masks(2 * g + 1))
    opt = cfg["algo"]["critic"]["optimizer"]
    tx = lambda: joptim.adam(opt["lr"], tuple(opt["betas"]), opt["eps"])  # noqa: E731
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    # one jitted critic step a call, each traced afresh (its masks and noise
    # are constants of the trace): three calls are the scan of three steps
    c, tc, c_opt, qf = jag.critic_params, jag.target_critic_params, tx().init(jag.critic_params), []
    for i in range(g):
        critic_fn, _ = jdroq.make_train_fn(fabric, jag, tx(), tx(), tx(), jdotdict(cfg))
        data = {k: jnp.asarray(v[i : i + 1]) for k, v in batch.items()}
        c, tc, c_opt, loss = critic_fn(jag.actor_params, c, tc, jag.log_alpha, c_opt, data, jax.random.PRNGKey(i))
        qf.append(float(loss))
    _, actor_fn = jdroq.make_train_fn(fabric, jag, tx(), tx(), tx(), jdotdict(cfg))
    a, la, a_opt, al_opt, actor_metrics = actor_fn(
        jag.actor_params, c, jag.log_alpha, tx().init(jag.actor_params), tx().init(jag.log_alpha),
        {"observations": jnp.asarray(actor_obs)}, jax.random.PRNGKey(9),
    )
    trainer = tdroq.DroQTrainer(tag, cfg, torch.device("cpu"), BATCH, 0, OBS_DIM, ACT_DIM)
    fn = trainer._graph(g, 0)
    for k, v in fn.inputs.items():
        v.copy_(t(batch[k]))
    got_qf = fn()
    actor = trainer._actor_graph()
    actor.inputs["observations"].copy_(t(actor_obs))
    got_actor = actor()
    close(got_qf, [np.mean(qf)], FWD_TOL, "critic loss")
    close(got_actor, actor_metrics, FWD_TOL, "actor losses")
    for module, tree in ((tag.actor, a), (tag.critic, c), (tag.target_critic, tc)):
        want = from_flax(module, tree)
        for name, p in module.named_parameters():
            close(p, want[name].numpy(), PARAM_TOL, name)
    close(tag.log_alpha, la, PARAM_TOL, "log_alpha")
    assert int(trainer.counter) == g and int(trainer.critic_opt.count) == g and int(trainer.actor_opt.count) == 1


DROQ = [
    "exp=droq",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.hidden_size=16",
    "algo.per_rank_batch_size=8",
    "algo.learning_starts=8",
    "algo.total_steps=16",
    "algo.replay_ratio=4",
    "buffer.size=64",
]


@pytest.mark.parametrize("device", [False, True])
def test_main_trains_on_each_replay(tmp_path, device):
    cfg = dotdict(compose("config", DROQ + [f"buffer.device={device}", f"log_base_dir={tmp_path}", "run_name=d"]))
    out = tdroq.main(cfg, device="cpu")
    assert out["replay_buffer"] == ("device" if device else "memmap")
    # G critic steps an update (Ratio at 4 x 2 envs after the first) and one actor step
    assert out["gradient_steps"] == 1 + 8 * 4 and out["train_windows"] == 5
    assert list(out["metrics"]) == ["Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"]
    assert all(np.isfinite(v) for v in out["metrics"].values())


def test_cli_dry_run_and_evaluation(tmp_path):
    argv = ["exp=droq", "fabric=cpu", "dry_run=True", "env.capture_video=False", "env.backend=sync", "algo.hidden_size=16", f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "droq" / "Pendulum-v1" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    state = load_checkpoint(ckpt)
    assert set(state["agent"]) == {"actor", "critics", "target_critics", "log_alpha"}
    assert "LayerNorm_0" in state["agent"]["critics"]["params"]
    cli.evaluation([f"checkpoint_path={ckpt}"])
