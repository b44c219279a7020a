"""The port's Dreamer-V1 (sheeprl_tpu_torch/algos/dreamer_v1, the GRU cell of
models/blocks.py and ops/math.py::compute_lambda_values_dv1) against the
JAX package's, at tiny widths on the CPU.

Weights come from the JAX package's ``build_agent`` (fp32, CPU), shifted by
seeded numpy noise and carried across with ``convert``; inputs are made
with numpy from a seed. The RSSM scan takes the JAX package's own normal
draws (its key splits replayed here) through ``agent.gaussian_noise``; the
train step and the player take one smooth sampler in both packages (a
fixed noise pattern for the Gaussian state, the straight-through mode for
actions), patched where each looks it up. Bounds: 1e-6 on the ops, 1e-5
forward and on a step's losses, 1e-4 on gradients and gradient norms.
"""

import glob
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import agent as jagent
from sheeprl_tpu.algos.dreamer_v1 import dreamer_v1 as jdv1
from sheeprl_tpu.algos.dreamer_v1.loss import reconstruction_loss as j_reconstruction_loss
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops.optim import adam as j_adam
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v1 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as tdv1
from sheeprl_tpu_torch.algos.dreamer_v1.convert import checkpoint_state, from_flax, load_checkpoint_state, to_flax
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.models.blocks import GRUCell
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_dreamer_v2 import _batch, _j_actions, _t_actions, obs_space
from tests.test_torch_dv3_train import _perturb, _recording, close, t

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
    "algo.horizon=3",
    f"algo.per_rank_batch_size={B_}",
    f"algo.per_rank_sequence_length={T_}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.num_envs=2",
]


def dv1_cfg(*extra, exp="dreamer_v1"):
    return dotdict(compose("config", [f"exp={exp}", "env=dummy", "env.id=dummy_discrete", *TINY, *extra]))


def jax_agent(cfg, actions_dim, is_continuous, space=None):
    """The JAX world model, actor and critic (fp32, CPU) with perturbed
    params."""
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    wm, wp, actor, ap, critic, cp, _ = jagent.build_agent(fabric, actions_dim, is_continuous, jdotdict(cfg.to_dict()), space or obs_space())
    return wm, _perturb(wp, 0), actor, _perturb(ap, 1), critic, _perturb(cp, 2)


def port_agent(cfg, actions_dim, is_continuous, wp, ap, cp):
    wm, actor, critic, player = tagent.build_agent(actions_dim, is_continuous, cfg, obs_space(), device="cpu")
    for m, tree in ((wm, wp), (actor, ap), (critic, cp)):
        m.load_state_dict(from_flax(m, tree))
    return wm, actor, critic, player


def _pattern(shape):
    """The smooth sampler's fixed standard-normal stand-in."""
    n = int(np.prod(shape))
    return (0.5 * np.sin(0.7 * np.arange(n) + 0.3)).reshape(shape).astype(np.float32)


def _j_stoch(self, out, key):
    mean, std = jnp.split(out, 2, axis=-1)
    std = jax.nn.softplus(std) + self.min_std
    return mean, std, mean + std * jnp.asarray(_pattern(mean.shape))


def _t_noise(like, generator=None):
    return torch.as_tensor(_pattern(tuple(like.shape))).to(like.dtype)


@pytest.fixture()
def deterministic(monkeypatch):
    monkeypatch.setattr(jagent.WorldModelDV1, "_stoch", _j_stoch)
    monkeypatch.setattr(tagent, "gaussian_noise", _t_noise)
    monkeypatch.setattr(jdv1, "sample_actor_actions", _j_actions)
    monkeypatch.setattr(tdv1, "sample_actor_actions", _t_actions)


# --------------------------------------------------------------------------- #
# the GRU cell, the lambda targets and the loss
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cell_matches_flax(dtype):
    """``GRUCell`` against flax's ``nn.GRUCell`` from the same params
    (the six Denses carried by the dense rule): fp32 within 1e-5 forward
    and 1e-4 on the input and params' gradients; at bf16 the output is
    bf16 as flax's and within 2^-6 of it (each product rounds to bf16)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cell = nn.GRUCell(6, dtype=jdt, param_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x, h = rng.standard_normal((3, 5)).astype(np.float32), rng.standard_normal((3, 6)).astype(np.float32)
    params = _perturb(cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)), 4)
    port = GRUCell(5, 6, compute_dtype=tdt)
    port.load_state_dict(from_flax(port, params))
    assert sorted(params["params"]) == sorted(GRUCell.GATES) and port.hr.bias is None and port.hn.bias is not None
    want, _ = cell.apply(params, jnp.asarray(h).astype(jdt), jnp.asarray(x).astype(jdt))
    got = port(t(h), t(x).to(tdt))
    assert got.dtype == tdt and str(want.dtype) == dtype
    if dtype == "bfloat16":
        close(got.float(), np.asarray(want, np.float32), 2.0**-6)
        return
    close(got, want, TOL)

    def jloss(p, h, x):
        return jnp.sum(jnp.sin(cell.apply(p, h, x)[0]))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(h), jnp.asarray(x))
    th, tx = t(h).requires_grad_(), t(x).requires_grad_()
    torch.sin(port(th, tx)).sum().backward()
    close(th.grad, jg[1], GRAD_TOL)
    close(tx.grad, jg[2], GRAD_TOL)
    want_g = from_flax(port, jg[0])
    for k, p in port.named_parameters():
        close(p.grad, want_g[k], GRAD_TOL, k)


def test_lambda_values_dv1_match():
    """``H - 1`` targets from an ``H``-step rollout, the last bootstrapped
    with the full last value."""
    rng = np.random.default_rng(1)
    r, v, c = (rng.standard_normal((6, 5, 1)).astype(np.float32) for _ in range(3))
    want = jm.compute_lambda_values_dv1(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), 0.9)
    got = tm.compute_lambda_values_dv1(t(r), t(v), t(c), 0.9)
    assert got.shape == (5, 5, 1)
    close(got, want, OP_TOL)
    # the last target: r + c * v_last, no (1 - lambda)
    close(got[-1], r[-2] + c[-2] * v[-1], OP_TOL)


@pytest.mark.parametrize("continues", [False, True])
def test_reconstruction_loss_matches(continues):
    rng = np.random.default_rng(2)
    rec, obs = (rng.standard_normal((T_, B_, 5)).astype(np.float32) for _ in range(2))
    rew_mean, rew = (rng.standard_normal((T_, B_, 1)).astype(np.float32) for _ in range(2))
    pm, qm = (rng.standard_normal((T_, B_, 4)).astype(np.float32) for _ in range(2))
    ps, qs = (rng.uniform(0.2, 2.0, (T_, B_, 4)).astype(np.float32) for _ in range(2))
    logits = rng.standard_normal((T_, B_, 1)).astype(np.float32)
    cont = (rng.uniform(size=(T_, B_, 1)) < 0.8).astype(np.float32) * 0.99
    # kl_free_nats 0.1: the KL of these states lies above it, so the
    # gradient path through the KL is the one compared
    want = j_reconstruction_loss(
        {"state": jd.Independent(jd.Normal(jnp.asarray(rec), jnp.ones_like(rec)), 1)},
        {"state": jnp.asarray(obs)},
        jd.Independent(jd.Normal(jnp.asarray(rew_mean), 1.0), 1),
        jnp.asarray(rew),
        jnp.asarray(pm), jnp.asarray(ps), jnp.asarray(qm), jnp.asarray(qs),
        0.1,
        1.5,
        jd.Independent(jd.Bernoulli(logits=jnp.asarray(logits)), 1) if continues else None,
        jnp.asarray(cont) if continues else None,
        10.0,
    )  # fmt: skip
    got = reconstruction_loss(
        {"state": td.Independent(td.Normal(t(rec), torch.ones(rec.shape)), 1)},
        {"state": t(obs)},
        td.Independent(td.Normal(t(rew_mean), torch.ones(rew_mean.shape)), 1),
        t(rew),
        t(pm), t(ps), t(qm), t(qs),
        0.1,
        1.5,
        td.Independent(td.Bernoulli(t(logits)), 1) if continues else None,
        t(cont) if continues else None,
        10.0,
    )  # fmt: skip
    for g, w in zip(got, want):
        close(g, w, OP_TOL)
    # free nats above the KL hold the state loss at them
    got = reconstruction_loss({}, {}, td.Independent(td.Normal(t(rew_mean), torch.ones(rew_mean.shape)), 1), t(rew), t(pm), t(ps), t(pm), t(ps), 3.0)
    assert float(got[1]) == 0.0 and float(got[2]) == 3.0


# --------------------------------------------------------------------------- #
# the RSSM scan, one train step, the converter and the player
# --------------------------------------------------------------------------- #


def _jax_draws(key, steps, shape):
    """The normal draws ``rssm_scan_dv1`` makes from ``key``: each step's
    prior, then its posterior."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_prior, k_post = jax.random.split(sub)
        out += [np.asarray(jax.random.normal(k_prior, shape)), np.asarray(jax.random.normal(k_post, shape))]
    return out


def test_rssm_scan_matches_with_the_jax_draws(monkeypatch):
    """The scan's six outputs from the same weights, embeddings, actions
    and normal draws (the JAX scan runs with its own keys; the port is
    handed the same draws in the same order)."""
    cfg = dv1_cfg()
    jwm, wp, _, ap, _, cp = jax_agent(cfg, (3,), False)
    twm, *_ = port_agent(cfg, (3,), False, wp, ap, cp)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((T_, B_, twm.embedding_dim)).astype(np.float32)
    acts = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T_, B_))]
    key = jax.random.PRNGKey(3)
    want = jagent.rssm_scan_dv1(jwm, wp, jnp.asarray(emb), jnp.asarray(acts), key)
    draws = iter(_jax_draws(key, T_, (B_, twm.stochastic_size)))
    monkeypatch.setattr(tagent, "gaussian_noise", lambda like, generator=None: t(next(draws)))
    got = tagent.rssm_scan_dv1(twm, t(emb), t(acts))
    assert next(draws, None) is None
    for name, g, w in zip(("hs", "zs", "post_mean", "post_std", "prior_mean", "prior_std"), got, want):
        close(g, w, TOL, name)
    assert jwm.cnn_encoder_output_dim + 8 == twm.embedding_dim  # the CNN's and the MLP encoder's widths


@pytest.mark.parametrize(
    "actions_dim, is_continuous, extra",
    [((3,), False, ()), ((2,), True, ("algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0.01"))],
)
def test_train_step_matches_jax(actions_dim, is_continuous, extra, deterministic):
    """One gradient step from the same weights and batch: the 13 metrics,
    the three models' gradients (a recording optax transformation hands
    back the JAX ones) and the updated params; the actor's gradient runs
    back through imagination (discrete straight-through and continuous
    actions; with a continue model and a KL above the free nats)."""
    cfg = dv1_cfg(*extra)
    jwm, wp, jact, ap, jcrit, cp = jax_agent(cfg, actions_dim, is_continuous)
    twm, tact, tcrit, _ = port_agent(cfg, actions_dim, is_continuous, wp, ap, cp)
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
    train_fn = jdv1.make_train_fn(fabric, jwm, jact, jcrit, *txs, jdotdict(cfg.to_dict()), is_continuous, actions_dim)
    d = _batch(actions_dim, is_continuous)
    opt_states = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    j_wp, j_ap, j_cp, *j_opts, j_metrics = train_fn(wp, ap, cp, *opt_states, {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0))
    opts = tdv3.build_optimizers(cfg, twm, tact, tcrit)
    step = tdv1.make_train_step(twm, tact, tcrit, *opts, cfg)
    grads = {}
    metrics = step({k: t(v) for k, v in d.items()}, None, grads)
    assert metrics.shape == (len(tdv1.METRIC_ORDER),) and tdv1.METRIC_ORDER == jdv1.METRIC_ORDER
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


def test_converter_round_trip_and_checkpoint_keys():
    """Every leaf of the JAX trees converts both ways (the GRU's six
    kernels transposed), the checkpoint holds the JAX keys (no target
    critic), and a checkpoint state loads back into the live modules."""
    cfg = dv1_cfg("algo.world_model.use_continues=True")
    _, wp, _, ap, _, cp = jax_agent(cfg, (3,), False)
    wm, actor, critic, _ = port_agent(cfg, (3,), False, wp, ap, cp)
    gru = wp["params"]["recurrent_model"]["GRUCell_0"]
    assert sorted(gru) == sorted(GRUCell.GATES)
    np.testing.assert_array_equal(wm.recurrent_model.GRUCell_0.hz.weight.detach().numpy(), np.asarray(gru["hz"]["kernel"]).T)
    for module, tree in ((wm, wp), (actor, ap), (critic, cp)):
        back = to_flax(module, module.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), tree, back)
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    state = checkpoint_state(wm, actor, critic, opts)
    assert set(state) == {"world_model", "actor", "critic", "world_optimizer", "actor_optimizer", "critic_optimizer"}
    wm2, actor2, critic2, _ = tagent.build_agent((3,), False, cfg, obs_space(), device="cpu")
    opts2 = tdv3.build_optimizers(cfg, wm2, actor2, critic2)
    load_checkpoint_state(state, wm2, actor2, critic2, opts2)
    for a, b in ((wm, wm2), (critic, critic2)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


def test_player_acts_and_resets(deterministic, monkeypatch):
    """The player's step against the JAX world model's ``observe_step`` and
    the actor from the same weights and zero states, then the per-env
    reset."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import agent as dv2_agent

    monkeypatch.setattr(dv2_agent, "sample_actor_actions", _t_actions)
    cfg = dv1_cfg()
    jwm, wp, jact, ap, _, cp = jax_agent(cfg, (3,), False)
    *_, player = port_agent(cfg, (3,), False, wp, ap, cp)
    rng = np.random.default_rng(4)
    obs = {"rgb": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8), "state": rng.standard_normal((2, 5)).astype(np.float32)}
    player.init_states()
    got = player.get_actions(obs)
    z, h = jwm.apply(wp, jnp.zeros((2, 4)), jnp.zeros((2, 8)), jnp.zeros((2, 3)), obs, jax.random.PRNGKey(0), method="observe_step")
    close(player.z, z, TOL)
    close(got, _j_actions(jact, ap, jnp.concatenate([z, h], -1), None), TOL)
    player.init_states([1])
    assert float(player.h[1].abs().sum()) == 0 and float(player.h[0].abs().sum()) > 0


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #


CLI = ["exp=dreamer_v1", "env=dummy", "env.id=dummy_discrete", "fabric=cpu", "env.capture_video=False", "env.backend=sync", "dry_run=True", "buffer.memmap=False"]
CLI += [a for a in TINY if not a.startswith("algo.per_rank_sequence_length")]
CLI += ["algo.per_rank_sequence_length=1", "algo.replay_ratio=1", "algo.per_rank_pretrain_steps=1", "buffer.checkpoint=True", "algo.run_test=True"]


def test_cli_dry_run_resumes_and_evaluates(tmp_path, monkeypatch):
    """``python -m sheeprl_tpu_torch exp=dreamer_v1 fabric=cpu dry_run=True``:
    a checkpoint with the JAX keys and the buffer, a resume from it that
    logs the exploration amount, then ``cli_eval`` on it. B1 is never
    launched."""
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(tmp_path / "RUNS.jsonl"))
    argv = CLI + [f"log_base_dir={tmp_path}"]
    fused_gru.reset_launch_count()
    cli.run(argv + ["run_name=a"])
    (ckpt,) = glob.glob(str(tmp_path / "dreamer_v1" / "dummy_discrete" / "a" / "version_0" / "checkpoint" / "*.ckpt"))
    state = load_checkpoint(ckpt)
    assert {"world_model", "actor", "critic", "world_optimizer", "ratio", "update", "rb"} <= set(state) and "target_critic" not in state
    more = ["dry_run=False", "algo.total_steps=6", "algo.learning_starts=0", "buffer.size=64", "algo.actor.expl_decay=4"]
    out = tdv1.main(dotdict(compose("config", argv + more + ["run_name=b", f"checkpoint.resume_from={ckpt}"])), device="cpu")
    assert out["start_update"] == 2 and out["env_steps"] == 6 and out["gradient_steps"] > 0
    assert out["replay_buffer"] == "host" and all(np.isfinite(v) for v in out["metrics"].values())
    # the decayed noise amount, 0.3 * 0.5 ** (step / 4), after each train
    # window (policy steps 4 and 6), averaged in the log
    assert out["exploration_amount"] == pytest.approx(0.3 * 0.5 ** (6 / 4))
    assert out["log"][-1][1]["Params/exploration_amount"] == pytest.approx(0.3 * (0.5 ** (4 / 4) + 0.5 ** (6 / 4)) / 2)
    cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert fused_gru.launch_count == 0


def test_main_resumes_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its param trees, optax states
    and threefry keys) resumes the port's ``main``: the counters continue,
    the keys reseed the streams with a warning, and the weights and Adam
    state load (no gradient step before the next checkpoint)."""
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    argv = CLI + [f"log_base_dir={tmp_path}", "run_name=j", "dry_run=False", "algo.total_steps=6", "algo.learning_starts=100", "buffer.size=64", "buffer.checkpoint=False"]
    cfg = dotdict(compose("config", argv))
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    _, wp, _, ap, _, cp = jax_agent(cfg, (2,), False, space)
    algo = cfg["algo"]
    txs = [
        j_adam(lr=algo[k]["optimizer"]["lr"], eps=algo[k]["optimizer"]["eps"], max_grad_norm=algo[k]["clip_gradients"])
        for k in ("world_model", "actor", "critic")
    ]
    key = jax.random.PRNGKey(0)
    state = {
        "world_model": wp,
        "actor": ap,
        "critic": cp,
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
        out = tdv1.main(cfg, device="cpu")
    assert out["start_update"] == 2 and out["env_steps"] == 6 and out["gradient_steps"] == 0
    (ckpt,) = glob.glob(os.path.join(out["log_dir"], "checkpoint", "*.ckpt"))
    saved = load_checkpoint(ckpt)
    assert saved["update"] == 3 and set(saved) >= set(state)
    for k in ("world_model", "critic"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b), state[k], saved[k])
    want, got = jax.tree.leaves(state["world_optimizer"]), jax.tree.leaves(saved["world_optimizer"])
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
