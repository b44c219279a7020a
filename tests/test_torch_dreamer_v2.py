"""The port's Dreamer-V2 (sheeprl_tpu_torch/algos/dreamer_v2 and the ops it
added) against the JAX package's, at tiny widths on the CPU.

Weights come from the JAX package's ``build_agent`` (fp32, CPU), shifted by
seeded numpy noise and carried across with ``convert``; inputs are made
with numpy from a seed. Both packages get the deterministic
straight-through sampler of ``tests/test_torch_dv3_train.py``, patched
where each looks it up (the JAX step is jitted and traces once). Bounds:
1e-6 on the ops, 1e-5 on a step's metrics and 1e-4 on its gradients, as
the Dreamer-V3 step is held.
"""

import glob
import os
import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jagent
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jdv2
from sheeprl_tpu.algos.dreamer_v2.loss import reconstruction_loss as j_reconstruction_loss
from sheeprl_tpu.data import EpisodeBuffer as JEpisodeBuffer
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops.optim import adam as j_adam
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as tdv2
from sheeprl_tpu_torch.algos.dreamer_v2.convert import checkpoint_state, from_flax, load_checkpoint_state, to_flax
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_dv3_train import _perturb, _recording, _t_state, _j_state, close, t

OP_TOL = 1e-6
TOL = 1e-5
GRAD_TOL = 1e-4
T_, B_ = 4, 2

TINY = [
    "fabric.precision=32-true",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.horizon=3",
    f"algo.per_rank_batch_size={B_}",
    f"algo.per_rank_sequence_length={T_}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.num_envs=2",
]


def dv2_cfg(*extra):
    return dotdict(compose("config", ["exp=dreamer_v2", "env=dummy", "env.id=dummy_discrete", *TINY, *extra]))


def obs_space():
    return spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (5,), np.float32)})


# --------------------------------------------------------------------------- #
# ops: the bootstrapped lambda-returns and the truncated normal
# --------------------------------------------------------------------------- #


def test_lambda_values_bootstrap_match():
    rng = np.random.default_rng(0)
    r, v, c = (rng.standard_normal((6, 5, 1)).astype(np.float32) for _ in range(3))
    boot = rng.standard_normal((1, 5, 1)).astype(np.float32)
    for b in (boot, None):
        want = jm.compute_lambda_values_bootstrap(r, v, c, None if b is None else jnp.asarray(b), lmbda=0.9)
        got = tm.compute_lambda_values_bootstrap(t(r), t(v), t(c), None if b is None else t(b), lmbda=0.9)
        close(got, want, OP_TOL)


def test_truncated_normal_matches():
    """``log_prob``, ``entropy``, ``mode``, ``mean`` and ``rsample`` from
    injected uniform noise (the inverse CDF) on [-1, 1]."""
    rng = np.random.default_rng(1)
    loc = np.tanh(rng.standard_normal((7, 3))).astype(np.float32)
    scale = (0.1 + rng.uniform(0.05, 2.0, (7, 3))).astype(np.float32)
    lo, hi = -np.ones_like(loc), np.ones_like(loc)
    jdist = jd.TruncatedNormal(jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(lo), jnp.asarray(hi))
    tdist = td.TruncatedNormal(t(loc), t(scale), t(lo), t(hi))
    x = rng.uniform(-0.99, 0.99, (7, 3)).astype(np.float32)
    p = rng.uniform(1e-6, 1 - 1e-6, (7, 3)).astype(np.float32)
    close(tdist.log_prob(t(x)), jdist.log_prob(jnp.asarray(x)), OP_TOL)
    close(tdist.entropy(), jdist.entropy(), OP_TOL)
    close(tdist.mode, jdist.mode, OP_TOL)
    close(tdist.mean, jdist.mean, OP_TOL)
    close(tdist.rsample(uniform=t(p)), jdist.icdf(jnp.asarray(p)), OP_TOL)
    draws = tdist.rsample(torch.Generator().manual_seed(0), (200,))
    assert draws.shape == (200, 7, 3) and bool((draws.abs() <= 1).all())
    # the draw carries the gradient of loc and scale (reparameterised)
    loc_t = t(loc).requires_grad_()
    td.TruncatedNormal(loc_t, t(scale), t(lo), t(hi)).rsample(uniform=t(p)).sum().backward()
    assert loc_t.grad is not None and bool(torch.isfinite(loc_t.grad).all())


@pytest.mark.parametrize("free_avg", [True, False])
def test_reconstruction_loss_matches(free_avg):
    rng = np.random.default_rng(2)
    rec = rng.standard_normal((T_, B_, 5)).astype(np.float32)
    obs = rng.standard_normal((T_, B_, 5)).astype(np.float32)
    rew_mean, rew = (rng.standard_normal((T_, B_, 1)).astype(np.float32) for _ in range(2))
    prior, post = (rng.standard_normal((T_, B_, 4, 4)).astype(np.float32) for _ in range(2))
    cont_logits = rng.standard_normal((T_, B_, 1)).astype(np.float32)
    cont = (rng.uniform(size=(T_, B_, 1)) < 0.8).astype(np.float32) * 0.99
    args = (0.8, 1.0, free_avg, 1.0)
    want = j_reconstruction_loss(
        {"state": jd.Independent(jd.Normal(jnp.asarray(rec), jnp.ones_like(rec)), 1)},
        {"state": jnp.asarray(obs)},
        jd.Independent(jd.Normal(jnp.asarray(rew_mean), 1.0), 1),
        jnp.asarray(rew),
        jnp.asarray(prior),
        jnp.asarray(post),
        *args,
        jd.Independent(jd.Bernoulli(logits=jnp.asarray(cont_logits)), 1),
        jnp.asarray(cont),
        0.5,
    )
    got = reconstruction_loss(
        {"state": td.Independent(td.Normal(t(rec), torch.ones(rec.shape)), 1)},
        {"state": t(obs)},
        td.Independent(td.Normal(t(rew_mean), torch.ones(rew_mean.shape)), 1),
        t(rew),
        t(prior),
        t(post),
        *args,
        td.Independent(td.Bernoulli(t(cont_logits)), 1),
        t(cont),
        0.5,
    )
    for g, w in zip(got, want):
        close(g, w, OP_TOL)


# --------------------------------------------------------------------------- #
# the episode buffer
# --------------------------------------------------------------------------- #


def _episodes(n_envs=2, steps=40, seed=3):
    """``steps`` rows of ``n_envs`` envs with episodes ending at random."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(steps):
        rows.append(
            {
                "obs": rng.integers(0, 255, (1, n_envs, 2, 2, 1)).astype(np.uint8),
                "step": np.full((1, n_envs, 1), i, np.float32),
                "terminated": (rng.uniform(size=(1, n_envs, 1)) < 0.12).astype(np.float32),
                "truncated": np.zeros((1, n_envs, 1), np.float32),
            }
        )
    return rows


@pytest.mark.parametrize("prioritize_ends", [False, True])
def test_episode_buffer_matches_the_jax_buffer(prioritize_ends):
    """The same adds (eviction of whole episodes included) and the same
    seed give the same episodes and the same windows as the JAX buffer;
    each window lies inside one episode."""
    kw = dict(buffer_size=30, minimum_episode_length=3, n_envs=2, obs_keys=("obs",), prioritize_ends=prioritize_ends, seed=7)
    jrb, trb = JEpisodeBuffer(**kw), EpisodeBuffer(**kw)
    for row in _episodes():
        for rb in (jrb, trb):
            try:
                rb.add(row)
            except RuntimeError as err:  # an episode shorter than the minimum
                assert "too short" in str(err)
                rb._open_episodes = [[] for _ in range(2)]
    assert len(trb) == len(jrb) <= 30 and len(trb.buffer) == len(jrb.buffer) > 1
    for a, b in zip(trb.buffer, jrb.buffer):
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    want = jrb.sample(3, n_samples=2, sequence_length=3)
    got = trb.sample(3, n_samples=2, sequence_length=3)
    assert got.keys() == want.keys() and got["obs"].shape == (2, 3, 3, 2, 2, 1)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # a window is consecutive steps of one episode: it never crosses a done
    steps, done = got["step"][..., 0], got["terminated"][..., 0]
    assert bool((np.diff(steps, axis=1) == 1).all()) and bool((done[:, :-1] == 0).all())


def test_episode_buffer_index_arithmetic_and_ends():
    """Given the draws, the gather reads the steps the indices name; with
    ``prioritize_ends`` every start past the last window clips to it, so
    the last window is drawn far more often."""
    rb = EpisodeBuffer(50, 2, n_envs=1, obs_keys=("step",), prioritize_ends=True, seed=0)
    rb.add({"step": np.arange(10, dtype=np.float32).reshape(10, 1, 1), "terminated": np.eye(10, dtype=np.float32)[-1].reshape(10, 1, 1), "truncated": np.zeros((10, 1, 1), np.float32)})
    out = rb.gather([0], [np.array([[2, 3, 4], [7, 8, 9]])], batch_size=2)
    np.testing.assert_array_equal(out["step"][0, :, :, 0], [[2, 7], [3, 8], [4, 9]])
    starts = rb.sample(1000, sequence_length=4)["step"][0, 0, :, 0]
    assert starts.max() == 6 and (starts == 6).mean() > 0.3
    rb.prioritize_ends = False
    starts = rb.sample(1000, sequence_length=4)["step"][0, 0, :, 0]
    assert 0.08 < (starts == 6).mean() < 0.22
    with pytest.raises(RuntimeError, match="No valid episodes"):
        rb.sample(1, sequence_length=20)


def test_memmapped_episode_buffer_pickles_its_contents(tmp_path):
    """Each episode in files of its own, removed on eviction; a pickle
    holds the arrays, so it loads after the files are gone."""
    rb = EpisodeBuffer(12, 2, n_envs=1, obs_keys=("step",), memmap=True, memmap_dir=tmp_path / "mm", seed=0)
    for start in (0, 5, 10):
        rb.add({"step": np.arange(start, start + 5, dtype=np.float32).reshape(5, 1, 1), "terminated": np.eye(5, dtype=np.float32)[-1].reshape(5, 1, 1), "truncated": np.zeros((5, 1, 1), np.float32)})
    assert len(rb.buffer) == 2 and len(os.listdir(tmp_path / "mm")) == 2  # the first evicted with its files
    blob = pickle.dumps(rb)
    shutil.rmtree(tmp_path / "mm")
    back = pickle.loads(blob)
    assert not back.is_memmap and [np.asarray(e["step"])[:, 0].tolist() for e in back.buffer] == [[5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
    assert back.sample(2, sequence_length=3)["step"].shape == (1, 3, 2, 1)


# --------------------------------------------------------------------------- #
# the agent and one train step
# --------------------------------------------------------------------------- #


def jax_agent(cfg, actions_dim, is_continuous, space=None):
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    wm, wp, actor, ap, critic, cp, _, _ = jagent.build_agent(fabric, actions_dim, is_continuous, jdotdict(cfg.to_dict()), space or obs_space())
    return wm, _perturb(wp, 0), actor, _perturb(ap, 1), critic, _perturb(cp, 2), _perturb(cp, 3)


def port_agent(cfg, actions_dim, is_continuous, wp, ap, cp, tp):
    wm, actor, critic, target, player = tagent.build_agent(actions_dim, is_continuous, cfg, obs_space(), device="cpu")
    for m, tree in ((wm, wp), (actor, ap), (critic, cp), (target, tp)):
        m.load_state_dict(from_flax(m, tree))
    return wm, actor, critic, target, player


def _j_actions(actor, params, state, key, greedy=False):
    dists = jagent.actor_dists(actor, actor.apply(params, state))
    if actor.is_continuous:
        return dists[0].mean
    return jnp.concatenate([d.mode + d.probs - jax.lax.stop_gradient(d.probs) for d in dists], -1)


def _t_actions(actor, state, generator=None, greedy=False):
    dists = tagent.actor_dists(actor, actor(state))
    if actor.is_continuous:
        return dists[0].mean
    return torch.cat([d.mode + d.probs - d.probs.detach() for d in dists], -1)


@pytest.fixture()
def deterministic(monkeypatch):
    monkeypatch.setattr(jagent, "compute_stochastic_state", _j_state)
    monkeypatch.setattr(tagent, "compute_stochastic_state", _t_state)
    monkeypatch.setattr(jdv2, "sample_actor_actions", _j_actions)
    monkeypatch.setattr(tdv2, "sample_actor_actions", _t_actions)


def _batch(actions_dim, is_continuous, seed=11):
    rng = np.random.default_rng(seed)
    d = {"rgb": rng.integers(0, 256, (T_, B_, 64, 64, 3)).astype(np.uint8), "state": (3 * rng.standard_normal((T_, B_, 5))).astype(np.float32)}
    if is_continuous:
        d["actions"] = rng.uniform(-1, 1, (T_, B_, sum(actions_dim))).astype(np.float32)
    else:
        d["actions"] = np.concatenate([np.eye(n, dtype=np.float32)[rng.integers(0, n, (T_, B_))] for n in actions_dim], -1)
    d["rewards"] = rng.standard_normal((T_, B_, 1)).astype(np.float32)
    d["terminated"] = (rng.uniform(size=(T_, B_, 1)) < 0.25).astype(np.float32)
    d["truncated"] = np.zeros((T_, B_, 1), np.float32)
    d["is_first"] = (rng.uniform(size=(T_, B_, 1)) < 0.25).astype(np.float32)
    return d


@pytest.mark.parametrize(
    "actions_dim, is_continuous, extra",
    [((3,), False, ()), ((2,), True, ("algo.world_model.use_continues=True", "algo.actor.objective_mix=0.5", "algo.world_model.kl_free_avg=False"))],
)
def test_train_step_matches_jax(actions_dim, is_continuous, extra, deterministic):
    """One gradient step from the same weights and batch: the 13 metrics,
    the three models' gradients (a recording optax transformation hands
    back the JAX ones) and the updated params; continuous actions with a
    dynamics term, whose gradient runs back through imagination."""
    cfg = dv2_cfg(*extra)
    jwm, wp, jact, ap, jcrit, cp, tp = jax_agent(cfg, actions_dim, is_continuous)
    twm, tact, tcrit, ttarget, _ = port_agent(cfg, actions_dim, is_continuous, wp, ap, cp, tp)
    algo = cfg["algo"]
    txs = [
        _recording(
            j_adam(
                lr=algo[k]["optimizer"]["lr"],
                betas=tuple(algo[k]["optimizer"]["betas"]),
                eps=algo[k]["optimizer"]["eps"],
                weight_decay=algo[k]["optimizer"]["weight_decay"],
                max_grad_norm=algo[k]["clip_gradients"],
            )
        )
        for k in ("world_model", "actor", "critic")
    ]
    fabric = types.SimpleNamespace(data_axis="data", world_size=1)
    train_fn = jdv2.make_train_fn(fabric, jwm, jact, jcrit, *txs, jdotdict(cfg.to_dict()), is_continuous, actions_dim)
    d = _batch(actions_dim, is_continuous)
    opt_states = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    j_wp, j_ap, j_cp, *j_opts, j_metrics = train_fn(wp, ap, cp, tp, *opt_states, {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0))
    opts = tdv3.build_optimizers(cfg, twm, tact, tcrit)
    step = tdv2.make_train_step(twm, tact, tcrit, ttarget, *opts, cfg)
    grads = {}
    metrics = step({k: t(v) for k, v in d.items()}, None, grads)
    close(metrics[:10], np.asarray(j_metrics)[:10], TOL)
    close(metrics[10:], np.asarray(j_metrics)[10:], GRAD_TOL)
    modules = {"world_model": twm, "actor": tact, "critic": tcrit}
    for (name, module), j_opt, new in zip(modules.items(), j_opts, (j_wp, j_ap, j_cp)):
        want = from_flax(module, j_opt[1])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], GRAD_TOL, f"{name} grad {k}")
        # Adam's first step moves each param by at most about lr: where
        # |g| is near eps a gradient within 1e-4 moves it by up to lr
        lr = algo[name]["optimizer"]["lr"]
        for k, w in from_flax(module, new).items():
            diff = (module.state_dict()[k] - w).abs()
            assert float(diff.max()) <= 2 * lr + 1e-6, f"{name} param {k}"
            big = want[k].abs() > 1e-3
            if big.any():
                assert float(diff[big].max()) <= 1e-6, f"{name} param {k} (|g| > 1e-3)"


def test_target_critic_is_a_hard_copy_every_freq_steps(deterministic):
    """``ReplayTrainer`` refreshes the target before the steps 0, freq,
    2 freq (the JAX ``cumulative % freq == 0``) with a hard copy."""
    cfg = dv2_cfg("algo.critic.per_rank_target_network_update_freq=2")
    wm, actor, critic, target, _ = tagent.build_agent((3,), False, cfg, obs_space(), device="cpu")
    with torch.no_grad():
        for p in target.parameters():
            p.add_(1.0)
    tdv2.hard_copy_(critic, target)
    for c, g in zip(critic.parameters(), target.parameters()):
        torch.testing.assert_close(g, c, rtol=0, atol=0)
    refreshed = []
    trainer = tdv3.ReplayTrainer(cfg, None, 1, None, lambda tau: refreshed.append(tau), torch.device("cpu"))
    trainer.fn = lambda: torch.zeros(13)
    trainer.prefetcher = types.SimpleNamespace(sampled_batches=lambda n: range(n))
    trainer.window(5)
    assert trainer.steps == 5 and len(refreshed) == 3


def test_converter_round_trip_and_checkpoint_keys():
    """Every leaf of the JAX trees converts both ways (a leaf left over
    raises), the checkpoint holds the JAX keys, and a checkpoint state
    loads back into the live modules."""
    cfg = dv2_cfg("algo.world_model.use_continues=True")
    _, wp, _, ap, _, cp, tp = jax_agent(cfg, (3,), False)
    wm, actor, critic, target, _ = port_agent(cfg, (3,), False, wp, ap, cp, tp)
    for module, tree in ((wm, wp), (actor, ap), (critic, cp)):
        back = to_flax(module, module.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), tree, back)
    with pytest.raises(KeyError, match="no port counterpart"):
        from_flax(actor, {"params": {**ap["params"], "extra": {"kernel": np.zeros(1)}}})
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    state = checkpoint_state(wm, actor, critic, target, opts)
    assert set(state) == {"world_model", "actor", "critic", "target_critic", "world_optimizer", "actor_optimizer", "critic_optimizer"}
    wm2, actor2, critic2, target2, _ = tagent.build_agent((3,), False, cfg, obs_space(), device="cpu")
    opts2 = tdv3.build_optimizers(cfg, wm2, actor2, critic2)
    load_checkpoint_state(state, wm2, actor2, critic2, target2, opts2)
    for a, b in ((wm, wm2), (target, target2)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


def test_player_acts_and_resets(deterministic, monkeypatch):
    """The player's step against the JAX player's jitted step from the same
    weights and zero states, and the per-env reset."""
    monkeypatch.setattr(tagent, "sample_actor_actions", _t_actions)
    cfg = dv2_cfg()
    jwm, wp, jact, ap, *_ = jax_agent(cfg, (3,), False)
    *_, player = port_agent(cfg, (3,), False, wp, ap, *jax_agent(cfg, (3,), False)[5:])
    rng = np.random.default_rng(4)
    obs = {"rgb": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8), "state": rng.standard_normal((2, 5)).astype(np.float32)}
    player.init_states()
    got = player.get_actions(obs)
    z, h = jwm.apply(wp, jnp.zeros((2, 16)), jnp.zeros((2, 8)), jnp.zeros((2, 3)), obs, jax.random.PRNGKey(0), method="observe_step")
    want = _j_actions(jact, ap, jnp.concatenate([z, h], -1), None)
    close(got, want, TOL)
    player.init_states([1])
    assert float(player.h[1].abs().sum()) == 0 and float(player.h[0].abs().sum()) > 0


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #


CLI = ["exp=dreamer_v2", "env=dummy", "env.id=dummy_discrete", "fabric=cpu", "env.capture_video=False", "env.backend=sync", "dry_run=True", "buffer.memmap=False"]
CLI += [a for a in TINY if not a.startswith("algo.per_rank_sequence_length")]
CLI += ["algo.per_rank_sequence_length=1", "algo.replay_ratio=1", "algo.per_rank_pretrain_steps=1", "buffer.checkpoint=True", "algo.run_test=True"]


@pytest.mark.parametrize("buffer_type", ["sequential", "episode"])
def test_cli_dry_run_resumes_and_evaluates(buffer_type, tmp_path, monkeypatch):
    """``python -m sheeprl_tpu_torch exp=dreamer_v2 fabric=cpu dry_run=True``
    with each buffer type (the episode buffer with ``prioritize_ends``):
    a checkpoint with the JAX keys and the buffer, a resume from it, then
    ``cli_eval`` on it. B1 is never launched."""
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(tmp_path / "RUNS.jsonl"))
    argv = CLI + [f"buffer.type={buffer_type}", "buffer.prioritize_ends=True", f"log_base_dir={tmp_path}"]
    fused_gru.reset_launch_count()
    cli.run(argv + ["run_name=a"])
    (ckpt,) = glob.glob(str(tmp_path / "dreamer_v2" / "dummy_discrete" / "a" / "version_0" / "checkpoint" / "*.ckpt"))
    state = load_checkpoint(ckpt)
    assert {"world_model", "actor", "critic", "target_critic", "world_optimizer", "ratio", "update", "rb"} <= set(state)
    assert isinstance(state["rb"][0] if isinstance(state["rb"], list) else state["rb"], EpisodeBuffer) is (buffer_type == "episode")
    # a resume (the CLI's would keep the stored dry run) trains updates 2
    # and 3 on the restored buffer
    more = ["dry_run=False", "algo.total_steps=6", "algo.learning_starts=0", "buffer.size=64"]
    out = tdv2.main(dotdict(compose("config", argv + more + ["run_name=b", f"checkpoint.resume_from={ckpt}"])), device="cpu")
    assert out["start_update"] == 2 and out["env_steps"] == 6 and out["gradient_steps"] > 0
    assert out["replay_buffer"] == ("episode" if buffer_type == "episode" else "host")
    assert all(np.isfinite(v) for v in out["metrics"].values())
    cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert fused_gru.launch_count == 0


def test_unknown_buffer_type_raises_with_the_jax_message(tmp_path):
    cfg = dv2_cfg("buffer.type=uniform", f"log_base_dir={tmp_path}")
    with pytest.raises(ValueError, match="Unrecognized buffer type"):
        tdv2.make_replay(cfg, str(tmp_path), ["rgb"])


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its param trees, optax states
    and threefry keys) resumes the port's ``main``: the counters continue,
    the keys reseed the streams with a warning, and the weights and Adam
    state load (the next checkpoint's target critic is the JAX one: no
    copy happened before the resume's first gradient step)."""
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    argv = CLI + ["buffer.type=sequential", f"log_base_dir={tmp_path}", "run_name=j", "dry_run=False", "algo.total_steps=6", "algo.learning_starts=100", "buffer.size=64", "buffer.checkpoint=False"]
    cfg = dotdict(compose("config", argv))
    # the dummy env's spaces: 64x64 pixels, a 10-wide state, two actions
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    _, wp, _, ap, _, cp, tp = jax_agent(cfg, (2,), False, space)
    algo = cfg["algo"]
    txs = [
        j_adam(
            lr=algo[k]["optimizer"]["lr"],
            betas=tuple(algo[k]["optimizer"]["betas"]),
            eps=algo[k]["optimizer"]["eps"],
            weight_decay=algo[k]["optimizer"]["weight_decay"],
            max_grad_norm=algo[k]["clip_gradients"],
        )
        for k in ("world_model", "actor", "critic")
    ]
    key = jax.random.PRNGKey(0)
    state = {
        "world_model": wp,
        "actor": ap,
        "critic": cp,
        "target_critic": tp,
        "world_optimizer": txs[0].init(wp),
        "actor_optimizer": txs[1].init(ap),
        "critic_optimizer": txs[2].init(cp),
        "ratio": {"_ratio": 1.0, "_prev": 2, "_pretrain_steps": 1},
        "update": 1,
        "batch_size": B_,
        "last_log": 0,
        "last_checkpoint": 2,
        "rng_key": key,
        "player_rng_key": key,
    }
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, state)
    cfg.checkpoint.resume_from = path
    with pytest.warns(UserWarning, match="not a torch generator state"):
        out = tdv2.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["env_steps"] == 6
    (ckpt,) = glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))
    saved = load_checkpoint(ckpt)
    assert saved["update"] == 3 and set(saved) >= set(state)
    assert out["gradient_steps"] == 0
    for key, tree in (("world_model", wp), ("target_critic", tp)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), tree, saved[key])
    want, got = jax.tree.leaves(state["world_optimizer"]), jax.tree.leaves(saved["world_optimizer"])
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
