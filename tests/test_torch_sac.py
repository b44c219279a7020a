"""SAC in the port against the JAX package on the CPU: the actor (its
forward, the log-prob of a sample with injected noise, the greedy action),
the stacked critic ensemble, the converters, one chunk of gradient steps
against the JAX ``make_train_fn`` (fp32), and ``python -m sheeprl_tpu_torch
exp=sac`` end to end on both replay paths (a checkpoint, a resume from the
port's and from the JAX package's, ``cli_eval``, the fused superstep and its
fallback).

Weights come from the JAX init (the target ensemble and ``log_alpha``
shifted, so the EMA and alpha show); inputs are numpy draws from a seed.
JAX threefry keys and torch generators never draw the same samples, so both
packages take the same Gaussian noise for each draw of a step: the jitted
JAX step's ``jax.random.normal`` looks its draw up by the key it is given
(the test derives the step's keys as the step splits them), the port's
``agent._normal_noise`` pops the draws in the order the step makes them.
"""

import copy
import functools
import glob
import json
import os

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jagent
from sheeprl_tpu.algos.sac import sac as jsac
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.convert import _nesting
from sheeprl_tpu_torch.algos.sac import agent as tagent
from sheeprl_tpu_torch.algos.sac import sac as tsac
from sheeprl_tpu_torch.algos.sac.convert import from_flax, to_flax
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict

FWD_TOL = 1e-5
PARAM_TOL = 1e-4
OBS_DIM, ACT_DIM, BATCH = 5, 2, 16


def t(a):
    return torch.as_tensor(np.asarray(a))


def sac_cfg(**algo):
    cfg = {
        "seed": 3,
        "fabric": {"precision": "32-true"},
        "env": {"num_envs": 1},
        "buffer": {"sample_next_obs": False},
        "algo": {
            "gamma": 0.99,
            "tau": 0.005,
            "mlp_keys": {"encoder": ["state"]},
            "actor": {"hidden_size": 16, "optimizer": {"lr": 3e-3, "eps": 1e-4, "betas": [0.9, 0.999]}},
            "critic": {"n": 2, "hidden_size": 16, "target_network_frequency": 1, "optimizer": {"lr": 3e-3, "eps": 1e-4, "betas": [0.9, 0.999]}},
            "alpha": {"alpha": 0.5, "optimizer": {"lr": 3e-3, "eps": 1e-4, "betas": [0.9, 0.999]}},
            "gradient_steps_chunk": 3,
        },
    }
    cfg["algo"].update(algo)
    return cfg


def _spaces(low=-2.0, high=2.0):
    j = (gymnasium.spaces.Dict({"state": gymnasium.spaces.Box(-np.inf, np.inf, (OBS_DIM,), np.float32)}), gymnasium.spaces.Box(low, high, (ACT_DIM,), np.float32))
    p = (spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (OBS_DIM,), np.float32)}), spaces.Box(low, high, (ACT_DIM,), np.float32))
    return j, p


def _shift(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _jax_agent(jbuild, cfg_json):
    """The JAX ``build_agent``'s agent of a config, built once a process
    (its eager init is the slow part of these tests)."""
    cfg = json.loads(cfg_json)
    jfab = JaxFabric(devices=1, precision=cfg["fabric"]["precision"], accelerator="cpu")
    return jbuild(jfab, jdotdict(cfg), *_spaces()[0])[0]


def jax_pair(cfg, jbuild=jagent.build_agent, tbuild=tagent.build_agent):
    """(JAX agent, port agent) from the same weights; the target critics
    and ``log_alpha`` shifted away from the online ones."""
    _, (pobs, pact) = _spaces()
    jag = copy.copy(_jax_agent(jbuild, json.dumps(cfg, sort_keys=True)))
    jag.actor_params = _shift(jax.device_get(jag.actor_params), 1)
    jag.critic_params = _shift(jax.device_get(jag.critic_params), 2)
    jag.target_critic_params = _shift(jax.device_get(jag.critic_params), 3)
    jag.log_alpha = jnp.asarray([np.log(0.5)], jnp.float32)
    state = {
        "actor": jag.actor_params,
        "critics": jag.critic_params,
        "target_critics": jag.target_critic_params,
        "log_alpha": np.asarray(jag.log_alpha),
    }
    tag, player = tbuild(cfg, pobs, pact, state, device="cpu")
    return jag, tag, player


def _batch(g, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "observations": rng.standard_normal((g, BATCH, OBS_DIM)).astype(np.float32),
        "next_observations": rng.standard_normal((g, BATCH, OBS_DIM)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (g, BATCH, ACT_DIM)).astype(np.float32),
        "rewards": rng.standard_normal((g, BATCH, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(g, BATCH, 1)) < 0.2).astype(np.float32),
    }


def inject_noise(monkeypatch, noises):
    """The same Gaussian draws, in order, in both packages."""
    j, p = list(noises), list(noises)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(j.pop(0)).reshape(shape))
    monkeypatch.setattr(tagent, "_normal_noise", lambda gen, like: torch.from_numpy(p.pop(0)).reshape(like.shape))
    return j, p


def key_noise(monkeypatch, table):
    """``jax.random.normal`` looking its draw up by the key it is given, at
    run time: ``table`` is ``[(key, noise)]`` with the keys the step will
    derive (a jitted scan then takes a draw of its own at every step)."""
    keys = jnp.stack([jax.random.key_data(k) for k, _ in table])
    draws = jnp.stack([jnp.asarray(n) for _, n in table])

    def normal(key, shape=(), dtype=jnp.float32):
        hit = jnp.all(keys == jax.random.key_data(key), axis=-1)
        return draws[jnp.argmax(hit)].reshape(shape)

    monkeypatch.setattr(jax.random, "normal", normal)


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol, err_msg=what)


# --------------------------------------------------------------------------- #
# the agent
# --------------------------------------------------------------------------- #


def test_actor_and_stacked_critics_match_jax(monkeypatch):
    cfg = sac_cfg()
    jag, tag, _ = jax_pair(cfg)
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((BATCH, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-2, 2, (BATCH, ACT_DIM)).astype(np.float32)
    mean, log_std = jag.actor.apply(jag.actor_params, obs)
    tmean, tlog_std = tag.actor(t(obs))
    close(tmean, mean, FWD_TOL, "mean")
    close(tlog_std, log_std, FWD_TOL, "log_std")
    # a sample and its log-prob on the same noise (log-std clipped, scale 2);
    # tanh near +-1 leaves log(1 - y^2) ill-conditioned in fp32, so no
    # draw here saturates it
    noise = rng.standard_normal((BATCH, ACT_DIM)).astype(np.float32)
    inject_noise(monkeypatch, [noise])
    ja, jlp = jagent.actor_action_and_log_prob(jag.actor, jag.actor_params, obs, jax.random.PRNGKey(0))
    ta, tlp = tagent.actor_action_and_log_prob(tag.actor, t(obs), None)
    close(ta, ja, FWD_TOL, "action")
    close(tlp, jlp, FWD_TOL, "log_prob")
    close(tagent.actor_greedy_action(tag.actor, t(obs)), jagent.actor_greedy_action(jag.actor, jag.actor_params, obs), FWD_TOL, "greedy")
    # the ensemble: [B, n], online and target
    close(tag.critic(t(obs), t(act)), jagent.critic_ensemble_apply(jag.critic, jag.critic_params, obs, act), FWD_TOL, "critics")
    close(tag.target_critic(t(obs), t(act)), jagent.critic_ensemble_apply(jag.critic, jag.target_critic_params, obs, act), FWD_TOL, "targets")


def test_finite_action_bounds_clamp_as_jax():
    box = spaces.Box(np.array([-2.0, -np.inf], np.float32), np.array([2.0, np.inf], np.float32))
    assert tagent.finite_action_bounds(box) == ((-2.0, -1.0), (2.0, 1.0))
    jbox = gymnasium.spaces.Box(np.array([-2.0, -np.inf], np.float32), np.array([2.0, np.inf], np.float32))
    assert tagent.finite_action_bounds(box) == jagent.finite_action_bounds(jbox)


def test_converters_round_trip_every_leaf():
    jag, tag, _ = jax_pair(sac_cfg())
    for module, tree in ((tag.actor, jag.actor_params), (tag.critic, jag.critic_params)):
        back = to_flax(module, from_flax(module, tree))
        assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, dict(tree)))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b))
    # the stacked kernels stay [n, in, out]
    assert tag.critic.Dense_0.kernel.shape == (2, OBS_DIM + ACT_DIM, 16)
    with pytest.raises(KeyError):
        from_flax(tag.actor, {"params": {"Dense_9": {"kernel": np.zeros((1, 1))}}})


# --------------------------------------------------------------------------- #
# the gradient step
# --------------------------------------------------------------------------- #


def jax_chunk(cfg, jag, batch, key=0):
    """The JAX ``make_train_fn`` over a ``[G, B]`` batch, jitted."""
    opt = cfg["algo"]["critic"]["optimizer"]
    tx = lambda: joptim.adam(opt["lr"], tuple(opt["betas"]), opt["eps"])  # noqa: E731
    train = jsac.make_train_fn(JaxFabric(devices=1, precision="32-true", accelerator="cpu"), jag, tx(), tx(), tx(), jdotdict(cfg))
    states = [tx().init(p) for p in (jag.actor_params, jag.critic_params, jag.log_alpha)]
    return train(
        jag.actor_params, jag.critic_params, jag.target_critic_params, jag.log_alpha, *states,
        jnp.zeros((), jnp.int32), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(key),
    )


def step_keys(key, g):
    """The (next-action, actor) keys of each of ``g`` scanned steps
    (``one_step``'s ``key, k_next, k_actor = split(key, 3)``)."""
    out = []
    for _ in range(g):
        key, k_next, k_actor = jax.random.split(key, 3)
        out += [k_next, k_actor]
    return out


@pytest.mark.parametrize("ema_every", [1, 2])
def test_a_chunk_of_steps_matches_jax_make_train_fn(monkeypatch, ema_every):
    """Three gradient steps as one chunk (the critics, the EMA every
    ``ema_every`` steps on the device counter, the actor, alpha): every
    parameter within ``PARAM_TOL``, the losses within ``FWD_TOL``, Adam's
    state in optax's nesting."""
    g = 3
    cfg = sac_cfg(critic={**sac_cfg()["algo"]["critic"], "target_network_frequency": ema_every})
    jag, tag, _ = jax_pair(cfg)
    batch = _batch(g)
    rng = np.random.default_rng(9)
    noise = [rng.standard_normal((BATCH, ACT_DIM)).astype(np.float32) for _ in range(2 * g)]
    key_noise(monkeypatch, list(zip(step_keys(jax.random.PRNGKey(0), g), noise)))
    monkeypatch.setattr(tagent, "_normal_noise", lambda gen, like: torch.from_numpy(noise.pop(0)).reshape(like.shape))
    a, c, tc, la, a_opt, c_opt, al_opt, counter, metrics = jax_chunk(cfg, jag, batch)
    trainer = tsac.SACTrainer(tag, cfg, torch.device("cpu"), BATCH, 0, OBS_DIM, ACT_DIM)
    fn = trainer._graph(g, 0)
    for k, v in fn.inputs.items():
        v.copy_(t(batch[k]))
    got = fn()
    close(got, metrics, FWD_TOL, "losses")
    assert int(trainer.counter) == int(counter) == g
    for module, tree in ((tag.actor, a), (tag.critic, c), (tag.target_critic, tc)):
        want = from_flax(module, tree)
        for name, p in module.named_parameters():
            close(p, want[name].numpy(), PARAM_TOL, name)
    close(tag.log_alpha, la, PARAM_TOL, "log_alpha")
    state = trainer.ckpt_state()
    for key, j in (("actor_optimizer", a_opt), ("qf_optimizer", c_opt), ("alpha_optimizer", al_opt)):
        assert _nesting(state[key]) == _nesting(j), key
        assert int(state[key][0].count) == g
        for x, y in zip(jax.tree.leaves(state[key][0].nu), jax.tree.leaves(j[0].nu)):
            close(x, y, PARAM_TOL, key)


def test_a_remainder_replays_the_one_step_graph():
    """A window of 2 full chunks and a remainder of 2 equals the same 8
    steps run one at a time, on the same batches and generator: the
    remainder is two replays of the one-step graph."""
    cfg = sac_cfg(gradient_steps_chunk=3)
    _, tag_a, _ = jax_pair(cfg)
    _, tag_b, _ = jax_pair(cfg)
    a = tsac.SACTrainer(tag_a, cfg, torch.device("cpu"), BATCH, 0, OBS_DIM, ACT_DIM)
    b = tsac.SACTrainer(tag_b, cfg, torch.device("cpu"), BATCH, 0, OBS_DIM, ACT_DIM)
    batch = _batch(8, seed=4)

    class Replay:  # a host buffer that hands out the rows in order
        row = 0

        def sample(self, batch_size, sample_next_obs=False, n_samples=1):
            out = {k: v[self.row : self.row + n_samples] for k, v in batch.items()}
            self.row += n_samples
            return out

    chunks = a.train_window(Replay(), 8)
    assert [s for s, _ in chunks] == [3, 3, 1, 1]
    assert sorted(k[1] for k in a.graphs) == [1, 3]
    rows = [b.step({k: t(v[i]) for k, v in batch.items()}, 0) for i in range(8)]
    for pa, pb in zip(tag_a.parameters(), tag_b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    want = torch.stack(rows).mean(0).numpy()
    from sheeprl_tpu_torch.utils.utils import weighted_chunk_metrics

    np.testing.assert_allclose(weighted_chunk_metrics(chunks), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #

SAC = [
    "exp=sac",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.hidden_size=16",
    "algo.per_rank_batch_size=8",
    "algo.learning_starts=8",
    "algo.total_steps=32",
    "buffer.size=64",
    "metric.log_every=16",
]


def _run(tmp_path, extra, name, module=tsac):
    cfg = dotdict(compose("config", SAC + [f"log_base_dir={tmp_path}", f"run_name={name}"] + extra))
    return module.main(cfg, device="cpu")


@pytest.mark.parametrize("device", [False, True])
def test_main_trains_checkpoints_and_resumes_on_each_replay(tmp_path, device):
    out = _run(tmp_path, [f"buffer.device={device}", "buffer.checkpoint=True"], "a")
    assert out["replay_buffer"] == ("device" if device else "memmap")
    assert out["updates"] == 16 and out["env_steps"] == 32 and out["gradient_steps"] == 1 + 2 * 12
    assert out["captures"] == 0 and out["test_steps"] > 0  # eager on the CPU
    assert all(np.isfinite(v) for v in out["metrics"].values())
    ckpts = sorted(glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt")))
    state = load_checkpoint(ckpts[-1])
    assert {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "ratio", "update", "batch_size", "last_log", "last_checkpoint", "rb"} <= set(state)
    assert set(state["agent"]) == {"actor", "critics", "target_critics", "log_alpha"}
    # resume into the other replay path
    res = _run(tmp_path, [f"buffer.device={not device}", "buffer.checkpoint=True", "algo.total_steps=48", f"checkpoint.resume_from={ckpts[-1]}"], "b")
    assert res["start_update"] == 17 and res["updates"] == 8 and res["replay_buffer"] == ("memmap" if device else "device")


def test_fused_superstep_on_the_ring_and_its_fallback(tmp_path, monkeypatch):
    """``algo.fused_gradient_steps=2``: chunks of 2 drawn inside the
    (eager) graph from the ring; on the host buffer one ``fused_fallback``
    (``host_buffer``) and the host gather."""
    out = _run(tmp_path, ["buffer.device=True", "algo.fused_gradient_steps=2"], "f")
    assert out["fused_gradient_steps"] == 2 and out["gradient_steps"] == 25
    assert all(np.isfinite(v) for v in out["metrics"].values())
    events = []
    monkeypatch.setattr(tsac, "fused_fallback", lambda reason, detail: events.append(reason))
    out = _run(tmp_path, ["buffer.device=False", "algo.fused_gradient_steps=2"], "h")
    assert events == ["host_buffer"] and out["fused_gradient_steps"] == 0


def test_a_forced_nan_rolls_back_to_the_last_checkpoint(tmp_path):
    cfg = dotdict(compose("config", SAC + [f"log_base_dir={tmp_path}", "run_name=drill", "checkpoint.every=8"]))
    cfg.resilience.fault_injection = {"enabled": True, "faults": [{"kind": "nan", "at_update": 10}]}
    out = tsac.main(cfg, device="cpu")
    assert out["rollbacks"] == 1 and out["updates"] == 16
    assert all(np.isfinite(v) for v in out["metrics"].values())


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its flax trees and optax states,
    a host ``ReplayBuffer``) resumes in the port: weights, Adam and the
    replay load; there are no generator states, so the streams are seeded
    with a warning."""
    from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer

    cfg = dotdict(compose("config", SAC + [f"log_base_dir={tmp_path}", "run_name=j", "buffer.checkpoint=True"]))
    jcfg = sac_cfg()
    jcfg["algo"]["hidden_size"] = 16
    (jobs, jact), _ = _spaces()
    jobs = gymnasium.spaces.Dict({"state": gymnasium.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    jact = gymnasium.spaces.Box(-2.0, 2.0, (1,), np.float32)
    jag, _ = jagent.build_agent(JaxFabric(devices=1, precision="32-true", accelerator="cpu"), jdotdict(jcfg), jobs, jact)
    tx = joptim.adam(3e-4, (0.9, 0.999), 1e-4)
    rb = JaxReplayBuffer(32, 2, obs_keys=("observations",))
    rng = np.random.default_rng(0)
    for _ in range(20):
        rb.add({
            "observations": rng.standard_normal((1, 2, 3)).astype(np.float32),
            "next_observations": rng.standard_normal((1, 2, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (1, 2, 1)).astype(np.float32),
            "rewards": rng.standard_normal((1, 2, 1)).astype(np.float32),
            "terminated": np.zeros((1, 2, 1), np.float32),
            "truncated": np.zeros((1, 2, 1), np.float32),
        })
    state = {
        "agent": {"actor": jag.actor_params, "critics": jag.critic_params, "target_critics": jag.target_critic_params, "log_alpha": jag.log_alpha},
        "qf_optimizer": tx.init(jag.critic_params),
        "actor_optimizer": tx.init(jag.actor_params),
        "alpha_optimizer": tx.init(jag.log_alpha),
        "ratio": {"_ratio": 1.0, "_prev": 20, "_pretrain_steps": 0},
        "update": 10,
        "batch_size": 8,
        "last_log": 16,
        "last_checkpoint": 20,
        "rb": rb,
    }
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, jax.device_get(state))
    cfg.checkpoint.resume_from = path
    with pytest.warns(UserWarning, match="not a torch generator state"):
        out = tsac.main(cfg, device="cpu")
    assert out["start_update"] == 11 and out["updates"] == 6 and out["gradient_steps"] == 12
    # the weights the run started from are the JAX package's
    loaded = load_checkpoint(path)
    _, pobs_act = _spaces()
    tag, _ = tagent.build_agent(cfg, spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (3,), np.float32)}), spaces.Box(-2.0, 2.0, (1,), np.float32), loaded["agent"], device="cpu")
    for name, p in tag.actor.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), from_flax(tag.actor, jax.device_get(jag.actor_params))[name].numpy())


def test_sac_decoupled_raises_naming_a10():
    cfg = dotdict(compose("config", ["exp=sac_decoupled", "fabric=cpu"]))
    with pytest.raises(NotImplementedError, match="A10"):
        cli.check_configs(cfg)


def test_cli_dry_run_checkpoints_resumes_and_evaluates(tmp_path):
    """``python -m sheeprl_tpu_torch exp=sac fabric=cpu dry_run=True`` (the
    CLI's ``run``): a checkpoint, a resume from it, ``cli_eval`` on it."""
    argv = ["exp=sac", "fabric=cpu", "dry_run=True", "env.capture_video=False", "env.backend=sync", "algo.hidden_size=16", f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "sac" / "Pendulum-v1" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    assert load_checkpoint(ckpt)["update"] == 1
    cli.run(argv + [f"checkpoint.resume_from={ckpt}"])
    assert os.path.isdir(tmp_path / "sac" / "Pendulum-v1" / "cli" / "version_1")
    cli.evaluation([f"checkpoint_path={ckpt}"])
