"""The port's Dreamer-V3 training path (sheeprl_tpu_torch) against the JAX
package's, module by module and one whole gradient step.

Weights are made by the JAX package's own init, shifted by seeded numpy
noise so no LayerNorm scale, bias or zero-initialised head is trivial, and
carried across with ``convert``; inputs are made with numpy from a seed.
Sizes are tiny, as ``tests/test_algos/test_dreamer_v3.py::dv3_args``: dense
8, recurrent 8, stoch 4x4, 16x16 pixels, T=4, B=2, horizon 3.

Noise: JAX keys and torch generators never draw the same samples, and the
JAX scan traces its body once, so both packages get the same deterministic
straight-through sampler, patched where each looks it up
(``agent.compute_stochastic_state`` and ``dreamer_v3.sample_actor_actions``):
the one-hot of the argmax plus ``probs - sg(probs)`` for categoricals, the
location (differentiable) for normal heads.

Tolerances, fp32 on the CPU: ``TOL`` 1e-5 on forward values and ``GRAD_TOL``
1e-4 on gradients (the JAX package's bounds for its own kernel,
tests/test_ops/test_pallas_gru.py); ``DEC_TOL`` 5e-5 on the CNN decoder's
output (its transposed-conv + LayerNorm stages, as the encoder's 5e-5).
"""

import glob
import itertools
import json
import os
import re
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jdv3
from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as j_reconstruction_loss
from sheeprl_tpu.data import device_buffer as jdb
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.ops.optim import adam as j_adam
from sheeprl_tpu.utils.utils import dotdict
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    actor_from_flax,
    cnn_decoder_from_flax,
    critic_from_flax,
    world_model_from_flax,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.data import device_buffer as tdb
from sheeprl_tpu_torch.envs import factory as tfactory
from sheeprl_tpu_torch.envs import jittable_pixels as tjp
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs import wrappers as tw
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.ops.optim import Adam
from sheeprl_tpu_torch.resilience import manager
from sheeprl_tpu_torch.utils.logger import read_scalars
from sheeprl_tpu_torch.utils.utils import save_configs

TOL = 1e-5
GRAD_TOL = 1e-4
DEC_TOL = 5e-5
T_, B_ = 4, 2

TINY = {
    "algo.dense_units": 8,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 8,
    "algo.world_model.transition_model.hidden_size": 8,
    "algo.world_model.representation_model.hidden_size": 8,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4,
    "algo.world_model.reward_model.bins": 15,
    "algo.critic.bins": 15,
    "algo.horizon": 3,
    "algo.per_rank_batch_size": B_,
    "algo.per_rank_sequence_length": T_,
    "env.screen_size": 16,
    "env.num_envs": 2,
}


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol, err_msg=msg)


def tiny_cfg(cnn=("rgb",), mlp=("state",), fused="auto", env="dummy_discrete", **extra):
    return compose(
        "XS",
        env=env,
        overrides={
            **TINY,
            # the JAX modules here are built at fp32, as the JAX tests pin fabric=cpu
            "fabric.precision": "32-true",
            "algo.cnn_keys.encoder": list(cnn),
            "algo.mlp_keys.encoder": list(mlp),
            "algo.world_model.recurrent_model.fused": fused,
            **extra,
        },
    )


def obs_space(cnn, mlp, screen=16):
    d = {k: spaces.Box(0, 255, (screen, screen, 3), np.uint8) for k in cnn}
    d.update({k: spaces.Box(-20, 20, (5,), np.float32) for k in mlp})
    return spaces.Dict(d)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)


def jax_modules(cfg, space, actions_dim, is_continuous, jfused="flax", seed=0):
    """The JAX world model, actor and critic for the port's ``cfg``, with
    perturbed params (the target critic perturbed apart)."""
    algo, wmc = cfg["algo"], cfg["algo"]["world_model"]
    cnn, mlp = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    screen = cfg["env"]["screen_size"]
    wm = jagent.WorldModel(
        cnn_keys=cnn,
        mlp_keys=mlp,
        cnn_output_channels=tuple(3 for _ in cnn),
        mlp_output_dims=tuple(space[k].shape[0] for k in mlp),
        image_size=(screen, screen),
        actions_dim=tuple(actions_dim),
        stochastic_size=wmc["stochastic_size"],
        discrete_size=wmc["discrete_size"],
        unimix=algo["unimix"],
        recurrent_state_size=wmc["recurrent_model"]["recurrent_state_size"],
        recurrent_dense_units=wmc["recurrent_model"]["dense_units"],
        fused_recurrent=jfused,
        encoder_cnn_multiplier=wmc["encoder"]["cnn_channels_multiplier"],
        encoder_mlp_layers=wmc["encoder"]["mlp_layers"],
        encoder_dense_units=wmc["encoder"]["dense_units"],
        decoder_cnn_multiplier=wmc["observation_model"]["cnn_channels_multiplier"],
        decoder_mlp_layers=wmc["observation_model"]["mlp_layers"],
        decoder_dense_units=wmc["observation_model"]["dense_units"],
        representation_hidden_size=wmc["representation_model"]["hidden_size"],
        transition_hidden_size=wmc["transition_model"]["hidden_size"],
        reward_bins=wmc["reward_model"]["bins"],
        reward_layers=wmc["reward_model"]["mlp_layers"],
        reward_dense_units=wmc["reward_model"]["dense_units"],
        continue_layers=wmc["discount_model"]["mlp_layers"],
        continue_dense_units=wmc["discount_model"]["dense_units"],
        cnn_stages=int(np.log2(screen) - 2),
    )
    obs = {k: np.zeros((1, screen, screen, 3), np.uint8) for k in cnn}
    obs.update({k: np.zeros((1, space[k].shape[0]), np.float32) for k in mlp})

    def init(m):
        emb = m.encode(obs)
        h = jnp.zeros((1, m.recurrent_state_size))
        z = jnp.zeros((1, m.stoch_state_size))
        a = jnp.zeros((1, int(sum(actions_dim))))
        h, z, _, _ = m.dynamic(z, h, a, emb, jnp.ones((1, 1)), jax.random.PRNGKey(1))
        lat = jnp.concatenate([z, h], -1)
        m.decode(lat)
        m.reward_logits(lat)
        m.continue_logits(lat)
        return ()

    wp = _perturb(nn.init(init, wm)(jax.random.PRNGKey(seed)), seed)
    a = algo["actor"]
    actor = jagent.Actor(
        latent_state_size=wm.latent_state_size,
        actions_dim=tuple(actions_dim),
        is_continuous=is_continuous,
        distribution=cfg["distribution"]["type"],
        init_std=a["init_std"],
        min_std=a["min_std"],
        max_std=a["max_std"],
        dense_units=a["dense_units"],
        mlp_layers=a["mlp_layers"],
        unimix=algo["unimix"],
        action_clip=a["action_clip"],
    )
    latent = jnp.zeros((1, wm.latent_state_size))
    ap = _perturb(actor.init(jax.random.PRNGKey(seed + 1), latent), seed + 1)
    critic = jagent.make_critic(dict(algo["critic"]), jnp.float32)
    raw = critic.init(jax.random.PRNGKey(seed + 2), latent)
    cp, tp = _perturb(raw, seed + 2), _perturb(raw, seed + 3)
    return wm, wp, actor, ap, critic, cp, tp


def port_modules(cfg, space, actions_dim, is_continuous, wp, ap, cp, tp):
    wm, actor, _ = tagent.build_agent(
        actions_dim, is_continuous, cfg, space, world_model_from_flax(wp), actor_from_flax(ap), device="cpu"
    )
    critic, target = tagent.build_critic(cfg, wm.latent_state_size, critic_from_flax(cp), critic_from_flax(tp), "cpu")
    return wm, actor, critic, target


# --------------------------------------------------------------------------- #
# the deterministic straight-through sampler, patched into both packages
# --------------------------------------------------------------------------- #


def _j_state(logits, key, sample=True):
    d = jd.OneHotCategorical(logits=logits)
    z = d.mode if not sample else d.mode + d.probs - jax.lax.stop_gradient(d.probs)
    return z.reshape(*z.shape[:-2], -1)


def _t_state(logits, generator=None, sample=True):
    d = td.OneHotCategorical(logits)
    z = d.mode if not sample else d.mode + d.probs - d.probs.detach()
    return z.reshape(*z.shape[:-2], -1)


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
    monkeypatch.setattr(jdv3, "sample_actor_actions", _j_actions)
    monkeypatch.setattr(tdv3, "sample_actor_actions", _t_actions)


def batch(cnn, mlp, actions_dim, is_continuous, seed=0, T=T_, B=B_):
    rng = np.random.default_rng(seed)
    d = {k: rng.integers(0, 256, (T, B, 16, 16, 3)).astype(np.uint8) for k in cnn}
    d.update({k: (3 * rng.standard_normal((T, B, 5))).astype(np.float32) for k in mlp})
    if is_continuous:
        d["actions"] = rng.uniform(-1, 1, (T, B, sum(actions_dim))).astype(np.float32)
    else:
        d["actions"] = np.concatenate(
            [np.eye(n, dtype=np.float32)[rng.integers(0, n, (T, B))] for n in actions_dim], -1
        )
    d["rewards"] = rng.standard_normal((T, B, 1)).astype(np.float32)
    d["terminated"] = (rng.uniform(size=(T, B, 1)) < 0.25).astype(np.float32)
    d["truncated"] = np.zeros((T, B, 1), np.float32)
    d["is_first"] = (rng.uniform(size=(T, B, 1)) < 0.25).astype(np.float32)
    return d


# --------------------------------------------------------------------------- #
# ops/math.py and ops/distributions.py
# --------------------------------------------------------------------------- #


def test_two_hot_encoder_and_decoder_match():
    """The supports of torch.linspace and jnp.linspace may differ by an ulp
    of the support's end (3.1e-5 at 300, 1.9e-6 at 20), which moves a
    two-hot weight by that ulp over the bucket size (1): hence 4e-5 at 300."""
    x = np.array([[-301.0], [-300.0], [-2.5], [0.0], [0.3], [17.0], [299.99], [300.0], [450.0]], np.float32)
    for sr, nb, tol in ((300, None, 4e-5), (20, 41, TOL), (5, 11, TOL)):
        got = tm.two_hot_encoder(t(x), sr, nb)
        want = jm.two_hot_encoder(jnp.asarray(x), sr, nb)
        close(got, want, tol)
        close(tm.two_hot_decoder(got, sr), jm.two_hot_decoder(want, sr), tol)


def test_lambda_values_and_normalize_match():
    rng = np.random.default_rng(1)
    r, v = rng.standard_normal((2, 6, 5, 1)).astype(np.float32)
    c = (rng.uniform(size=(6, 5, 1)) < 0.8).astype(np.float32) * 0.99
    close(tm.compute_lambda_values(t(r), t(v), t(c), 0.95), jm.compute_lambda_values(r, v, c, 0.95))
    x = rng.standard_normal((7, 3)).astype(np.float32)
    mask = rng.uniform(size=(7, 3)) < 0.5
    close(tm.normalize(t(x)), jm.normalize(jnp.asarray(x)))
    close(tm.normalize(t(x), mask=t(mask)), jm.normalize(jnp.asarray(x), mask=jnp.asarray(mask)))


def test_moments_match_over_steps():
    rng = np.random.default_rng(2)
    js, ts = jm.init_moments(), tm.init_moments()
    for i in range(4):
        x = (rng.standard_normal((16, 9, 1)) * (i + 1)).astype(np.float32)
        js, (jl, ji) = jm.update_moments(js, jnp.asarray(x), decay=0.99, max_=1.0)
        ts, (tl, ti) = tm.update_moments(ts, t(x), decay=0.99, max_=1.0)
        close(ts.low, js.low)
        close(ts.high, js.high)
        close(tl, jl)
        close(ti, ji)


def test_dreamer_heads_match():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((3, 4, 5)).astype(np.float32)
    val = (4 * rng.standard_normal((3, 4, 5))).astype(np.float32)
    val[0, 0, 0] = np.sinh(0.0)
    for kw in ({}, {"dist": "abs", "agg": "mean"}):
        tj, jj = td.SymlogDistribution(t(pred), dims=2, **kw), jd.SymlogDistribution(pred, dims=2, **kw)
        close(tj.log_prob(t(val)), jj.log_prob(val))
        close(tj.mode, jj.mode)
    close(td.MSEDistribution(t(pred), dims=2).log_prob(t(val)), jd.MSEDistribution(pred, dims=2).log_prob(val))
    logits = rng.standard_normal((3, 4, 15)).astype(np.float32)
    x = (30 * rng.standard_normal((3, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # on a bin
    x[0, 1, 0] = 1e9  # past the last bin
    th, jh = td.TwoHotEncodingDistribution(t(logits), dims=1), jd.TwoHotEncodingDistribution(logits, dims=1)
    close(th.log_prob(t(x)), jh.log_prob(x))
    close(th.mean, jh.mean)
    lg = (3 * rng.standard_normal((3, 4, 1))).astype(np.float32)
    tb, jb = td.Independent(td.Bernoulli(t(lg)), 1), jd.Independent(jd.Bernoulli(logits=lg), 1)
    tgt = (rng.uniform(size=lg.shape) < 0.5).astype(np.float32)
    close(tb.log_prob(t(tgt)), jb.log_prob(tgt))
    close(tb.mode, jb.mode)
    close(tb.entropy(), jb.entropy())
    p, q = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    close(
        td.kl_divergence(td.Independent(td.OneHotCategorical(t(p)), 1), td.Independent(td.OneHotCategorical(t(q)), 1)),
        jd.kl_divergence(jd.Independent(jd.OneHotCategorical(logits=p), 1), jd.Independent(jd.OneHotCategorical(logits=q), 1)),
    )


def test_tanh_normal_matches():
    rng = np.random.default_rng(4)
    loc = rng.standard_normal((5, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 1.5, (5, 2)).astype(np.float32)
    v = rng.uniform(-0.99, 0.99, (5, 2)).astype(np.float32)
    tt, jt = td.TanhNormal(t(loc), t(scale)), jd.TanhNormal(loc, scale)
    close(tt.log_prob(t(v)), jt.log_prob(v), 1e-4)
    close(tt.mode, jt.mode)
    a, lp = tt.rsample_and_log_prob(torch.Generator().manual_seed(0))
    assert a.shape == (5, 2) and float(a.abs().max()) < 1
    close(lp, tt.log_prob(a), 1e-3)


# --------------------------------------------------------------------------- #
# decoders, heads, the sequence path, actor and critic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("screen, mult", [(16, 2), (64, 2)])
def test_cnn_decoder_matches(screen, mult):
    """Flax's ConvTranspose (transpose_kernel=False, explicit (2, 2) padding)
    against nn.ConvTranspose2d with the converter's flipped kernels."""
    stages = int(np.log2(screen) - 2)
    jdec = jagent.CNNDecoder(("rgb", "depth"), (3, 1), mult, (screen, screen), stages)
    latent = np.random.default_rng(5).standard_normal((2, 3, 24)).astype(np.float32)
    params = _perturb(jdec.init(jax.random.PRNGKey(0), latent), 5)
    tdec = tagent.CNNDecoder(("rgb", "depth"), (3, 1), mult, 24, screen, stages)
    tdec.load_state_dict(cnn_decoder_from_flax(params))
    want = jdec.apply(params, latent)
    got = tdec(t(latent))
    for k in ("rgb", "depth"):
        assert got[k].shape == (2, 3, screen, screen, 3 if k == "rgb" else 1)
        close(got[k], want[k], DEC_TOL, k)


def test_world_model_decode_reward_continue_match():
    cfg = tiny_cfg()
    space = obs_space(("rgb",), ("state",))
    jwm, wp, _, ap, _, cp, tp = jax_modules(cfg, space, (3,), False)
    twm, *_ = port_modules(cfg, space, (3,), False, wp, ap, cp, tp)
    lat = np.random.default_rng(6).standard_normal((3, 2, twm.latent_state_size)).astype(np.float32)
    dj, dt = jwm.apply(wp, lat, method=jagent.WorldModel.decode), twm.decode(t(lat))
    assert dj.keys() == dt.keys() == {"rgb", "state"}
    close(dt["rgb"], dj["rgb"], DEC_TOL)
    close(dt["state"], dj["state"])
    close(twm.reward_logits(t(lat)), jwm.apply(wp, lat, method=jagent.WorldModel.reward_logits))
    close(twm.continue_logits(t(lat)), jwm.apply(wp, lat, method=jagent.WorldModel.continue_logits))


@pytest.mark.parametrize("jfused, tfused", [("pallas", "auto"), ("flax", "flax")])
def test_rssm_scan_and_imagination_match(jfused, tfused, deterministic):
    """rssm_scan with is_first restarts, then imagination steps, forward and
    the scan's parameter gradients; the JAX step as the Pallas kernel in
    interpret mode or the flax cell, the port's as the fused wrapper (its
    plain version on CPU tensors) or the plain RecurrentModel."""
    cfg = tiny_cfg(fused=tfused)
    space = obs_space(("rgb",), ("state",))
    jwm, wp, _, ap, _, cp, tp = jax_modules(cfg, space, (3,), False, jfused=jfused)
    twm, *_ = port_modules(cfg, space, (3,), False, wp, ap, cp, tp)
    assert twm.fused is (tfused == "auto")
    d = batch(("rgb",), ("state",), (3,), False, seed=7)
    obs = {k: d[k] for k in ("rgb", "state")}

    def j_loss(p):
        emb = jwm.apply(p, obs, method=jagent.WorldModel.encode)
        hs, zs, post, prior = jagent.rssm_scan(jwm, p, emb, d["actions"], d["is_first"], jax.random.PRNGKey(0))
        return (hs.sum() + (post * prior).sum() + zs.sum() * 0.5), (hs, zs, post, prior)

    (_, jout), jgrad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(wp)
    emb = twm.encode({k: t(v) for k, v in obs.items()})
    tout = tagent.rssm_scan(twm, emb, t(d["actions"]), t(d["is_first"]))
    loss = tout[0].sum() + (tout[2] * tout[3]).sum() + tout[1].sum() * 0.5
    names = [n for n, _ in twm.named_parameters()]
    tgrad = dict(zip(names, torch.autograd.grad(loss, list(twm.parameters()), allow_unused=True)))
    for a, b in zip(tout, jout):
        close(a, b)
    for k, v in world_model_from_flax(jgrad).items():
        g = tgrad[k] if tgrad[k] is not None else torch.zeros_like(v)
        close(g, v, GRAD_TOL, k)
    # imagination from the last posterior
    z, h = tout[1][-1].detach(), tout[0][-1].detach()
    jz, jh = np.asarray(jout[1][-1]), np.asarray(jout[0][-1])
    a = np.eye(3, dtype=np.float32)[[0, 2]]
    for _ in range(3):
        jz, jh = jwm.apply(wp, jz, jh, a, jax.random.PRNGKey(1), method=jagent.WorldModel.imagination)
        z, h = twm.imagination(z, h, t(a))
        close(h, jh)
        close(z, jz)


@pytest.mark.parametrize(
    "actions_dim, is_continuous, dist",
    [((3,), False, "auto"), ((3, 2), False, "auto"), ((2,), True, "auto"), ((2,), True, "tanh_normal")],
)
def test_actor_logprob_entropy_and_critic_match(actions_dim, is_continuous, dist):
    cfg = tiny_cfg(**{"distribution.type": dist})
    space = obs_space(("rgb",), ("state",))
    _, wp, jact, ap, jcrit, cp, tp = jax_modules(cfg, space, actions_dim, is_continuous)
    _, tact, tcrit, _ = port_modules(cfg, space, actions_dim, is_continuous, wp, ap, cp, tp)
    rng = np.random.default_rng(8)
    states = rng.standard_normal((4, 3, tact.mlp.linears[0].in_features)).astype(np.float32)
    if is_continuous:
        acts = rng.uniform(-0.9, 0.9, (4, 3, sum(actions_dim))).astype(np.float32)
    else:
        acts = np.concatenate([np.eye(n, dtype=np.float32)[rng.integers(0, n, (4, 3))] for n in actions_dim], -1)
    if dist == "tanh_normal":
        # TanhNormal has no entropy: the JAX function raises AttributeError,
        # the port NotImplementedError; the head's log-density still matches
        with pytest.raises(AttributeError):
            jagent.actor_logprob_entropy(jact, ap, states, acts)
        with pytest.raises(NotImplementedError):
            tagent.actor_logprob_entropy(tact, t(states), t(acts))
        jd_ = jagent.actor_dists(jact, jact.apply(ap, states))[0]
        td_ = tagent.actor_dists(tact, tact(t(states)))[0]
        close(td_.loc, jd_.loc)
        close(td_.log_prob(t(acts)), jd_.log_prob(acts), 1e-4)
    else:
        lp_t, ent_t = tagent.actor_logprob_entropy(tact, t(states), t(acts))
        lp_j, ent_j = jagent.actor_logprob_entropy(jact, ap, states, acts)
        close(lp_t, lp_j)
        close(ent_t, ent_j)
    close(tcrit(t(states)), jcrit.apply(cp, states))


def test_greedy_tanh_normal_actions_are_the_most_likely_candidates():
    """The reference defines no greedy TanhNormal action: its sampler takes
    the argmax of a per-dimension density and raises ValueError in
    take_along_axis. The port raises NotImplementedError there and samples
    as the reference does otherwise."""
    cfg = tiny_cfg(**{"distribution.type": "tanh_normal"})
    _, wp, jact, ap, _, cp, tp = jax_modules(cfg, obs_space(("rgb",), ("state",)), (2,), True)
    _, tact, _, _ = port_modules(cfg, obs_space(("rgb",), ("state",)), (2,), True, wp, ap, cp, tp)
    states = np.random.default_rng(12).standard_normal((3, tact.mlp.linears[0].in_features)).astype(np.float32)
    with pytest.raises(ValueError):
        jagent.sample_actor_actions(jact, ap, states, jax.random.PRNGKey(0), greedy=True)
    with pytest.raises(NotImplementedError):
        tagent.sample_actor_actions(tact, t(states), torch.Generator().manual_seed(0), greedy=True)
    sampled = tagent.sample_actor_actions(tact, t(states), torch.Generator().manual_seed(0))
    jsampled = jagent.sample_actor_actions(jact, ap, states, jax.random.PRNGKey(0))
    assert sampled.shape == jsampled.shape == (3, 2)
    assert torch.all(sampled.abs() <= 1) and np.all(np.abs(np.asarray(jsampled)) <= 1)


def test_reconstruction_loss_matches():
    rng = np.random.default_rng(9)
    T, B, S, D = 3, 2, 4, 5
    prior, post = rng.standard_normal((2, T, B, S, D)).astype(np.float32)
    img, img_t = rng.standard_normal((2, T, B, 8, 8, 3)).astype(np.float32)
    vec, vec_t = (2 * rng.standard_normal((2, T, B, 5))).astype(np.float32)
    rew_logits = rng.standard_normal((T, B, 15)).astype(np.float32)
    rew = rng.standard_normal((T, B, 1)).astype(np.float32)
    cont_logits = rng.standard_normal((T, B, 1)).astype(np.float32)
    cont = (rng.uniform(size=(T, B, 1)) < 0.8).astype(np.float32)
    for free_nats in (1.0, 0.05):
        want = j_reconstruction_loss(
            {"rgb": jd.MSEDistribution(img, dims=3), "state": jd.SymlogDistribution(vec, dims=1)},
            {"rgb": img_t, "state": vec_t},
            jd.TwoHotEncodingDistribution(rew_logits, dims=1),
            rew,
            prior,
            post,
            0.5,
            0.1,
            free_nats,
            1.0,
            jd.Independent(jd.Bernoulli(logits=cont_logits), 1),
            cont,
            1.0,
        )
        got = reconstruction_loss(
            {"rgb": td.MSEDistribution(t(img), dims=3), "state": td.SymlogDistribution(t(vec), dims=1)},
            {"rgb": t(img_t), "state": t(vec_t)},
            td.TwoHotEncodingDistribution(t(rew_logits), dims=1),
            t(rew),
            t(prior),
            t(post),
            0.5,
            0.1,
            free_nats,
            1.0,
            td.Independent(td.Bernoulli(t(cont_logits)), 1),
            t(cont),
            1.0,
        )
        for a, b in zip(got, want):
            close(a, b)


# --------------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("weight_decay, clip", [(0.0, 0.5), (0.01, 0.0), (0.0, 1e6)])
def test_adam_matches_optax_over_ten_steps(weight_decay, clip):
    """N-step parity on identical gradient streams, clipping active in the
    first case (the stream's norm is ~10 against a max of 0.5), at 1e-6. The
    fifth step's gradients are all zero: a zero norm leaves them unclipped
    and the parameters finite."""
    rng = np.random.default_rng(10)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = j_adam(lr=1e-2, betas=(0.9, 0.99), eps=1e-5, weight_decay=weight_decay, max_grad_norm=clip)
    jp, state = list(params), tx.init(list(params))
    tp = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt = Adam(tp, lr=1e-2, betas=(0.9, 0.99), eps=1e-5, weight_decay=weight_decay, max_grad_norm=clip)
    for i in range(10):
        grads = [(3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        if i == 4:
            grads = [np.zeros_like(g) for g in grads]
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([t(g) for g in grads])
        close(norm, optax.global_norm(grads), 1e-6)
        for a, b in zip(tp, jp):
            assert torch.isfinite(a).all()
            close(a, b, 1e-6)


def test_adam_clips_by_max_over_norm_without_epsilon():
    p = torch.nn.Parameter(torch.zeros(2))
    g = torch.tensor([3.0, 4.0])
    opt = Adam([p], lr=1.0, eps=0.0, max_grad_norm=1.0)
    assert float(opt.step([g])) == 5.0
    # first Adam step: lr * sign(g) whatever the scale; the moments hold g / 5
    torch.testing.assert_close(opt.mu[0], 0.1 * g / 5.0)
    torch.testing.assert_close(p.detach(), -torch.ones(2))


# --------------------------------------------------------------------------- #
# the whole train step
# --------------------------------------------------------------------------- #


def _recording(tx):
    """``tx`` whose state also carries the last gradients it was given, so a
    jitted train step hands them back in its optimizer state."""

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_tx(opt_cfg, clip):
    return j_adam(lr=opt_cfg["lr"], betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"], max_grad_norm=clip)


@pytest.mark.parametrize(
    "actions_dim, is_continuous, env", [((3,), False, "dummy_discrete"), ((2,), True, "dummy_continuous")]
)
def test_train_step_matches_jax(actions_dim, is_continuous, env, deterministic):
    """One gradient step through both packages from the same weights and
    batch: the 13 metrics, the three models' gradients, the updated params
    and the MomentsState. The port's recurrent step is the fused wrapper
    (plain version on CPU tensors); with continuous actions the actor's
    gradient flows back through imagination and its backward."""
    cfg = tiny_cfg(env=env)
    space = obs_space(("rgb",), ("state",))
    jwm, wp, jact, ap, jcrit, cp, tp = jax_modules(cfg, space, actions_dim, is_continuous)
    twm, tact, tcrit, ttarget = port_modules(cfg, space, actions_dim, is_continuous, wp, ap, cp, tp)
    assert twm.fused
    algo = cfg["algo"]
    txs = [_recording(_jax_tx(algo[k]["optimizer"], algo[k]["clip_gradients"])) for k in ("world_model", "actor", "critic")]
    fabric = types.SimpleNamespace(data_axis="data", world_size=1, model_axis=None)
    local_train, use_shard_map = jdv3.make_train_step(
        fabric, jwm, jact, jcrit, *txs, dotdict(cfg), is_continuous, actions_dim
    )
    assert not use_shard_map
    d = batch(("rgb",), ("state",), actions_dim, is_continuous, seed=11)
    jd_ = {k: jnp.asarray(v) for k, v in d.items()}
    opt_states = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    out = jax.jit(local_train)(wp, ap, cp, tp, *opt_states, jm.init_moments(), jd_, jax.random.PRNGKey(0))
    j_wp, j_ap, j_cp, *j_opts, j_moments, j_metrics = out
    log = {k: o[1] for k, o in zip(("world_model", "actor", "critic"), j_opts)}

    opts = tdv3.build_optimizers(cfg, twm, tact, tcrit)
    step = tdv3.make_train_step(twm, tact, tcrit, ttarget, *opts, cfg, is_continuous)
    grads = {}
    fused_gru.reset_launch_count()
    t_moments, t_metrics = step(tm.init_moments(), {k: t(v) for k, v in d.items()}, None, grads)
    assert fused_gru.launch_count == 0  # CPU tensors: the plain version ran

    # metrics: losses at the forward bound, gradient norms at the gradient one
    close(t_metrics[:10], np.asarray(j_metrics)[:10], TOL)
    close(t_metrics[10:], np.asarray(j_metrics)[10:], GRAD_TOL)
    close(t_moments.low, j_moments.low)
    close(t_moments.high, j_moments.high)

    convert = {"world_model": world_model_from_flax, "actor": actor_from_flax, "critic": critic_from_flax}
    modules = {"world_model": twm, "actor": tact, "critic": tcrit}
    for name, module in modules.items():
        want = convert[name](log[name])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], GRAD_TOL, f"{name} grad {k}")

    # updated params. Adam's first step is lr * g / (|g| + eps), within lr of
    # zero whatever g: where |g| is near eps a gradient difference of 1e-4
    # relative moves it by up to lr, so the bound is 2 lr + 1e-6 everywhere
    # and 1e-6 where |g| > 1e-3 (the step is then lr * sign(g) to 1e-5).
    for name, new in (("world_model", j_wp), ("actor", j_ap), ("critic", j_cp)):
        want = convert[name](new)
        want = want[0] if isinstance(want, tuple) else want
        jg = convert[name](log[name])
        jg = jg[0] if isinstance(jg, tuple) else jg
        lr = algo[name]["optimizer"]["lr"]
        state = modules[name].state_dict()
        for k in want:
            diff = (state[k] - want[k]).abs()
            assert float(diff.max()) <= 2 * lr + 1e-6, f"{name} param {k}"
            big = jg[k].abs() > 1e-3
            if big.any():
                assert float(diff[big].max()) <= 1e-6, f"{name} param {k} (|g| > 1e-3)"


def test_target_critic_ema():
    cfg = tiny_cfg()
    critic, target = tagent.build_critic(cfg, 24, device="cpu")
    with torch.no_grad():
        for p in target.parameters():
            p.add_(1.0)
    before = [p.clone() for p in target.parameters()]
    tdv3.ema_(critic, target, 0.02)
    for c, b, a in zip(critic.parameters(), before, target.parameters()):
        torch.testing.assert_close(a, 0.02 * c + 0.98 * b)
    tdv3.ema_(critic, target, 1.0)
    for c, a in zip(critic.parameters(), target.parameters()):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# the converter and the loop
# --------------------------------------------------------------------------- #


def test_converter_round_trip_with_nothing_left_unported():
    """Every leaf of the JAX param trees converts (an unconverted leaf
    raises) and loads into the port's modules as it was converted."""
    cfg = tiny_cfg()
    space = obs_space(("rgb",), ("state",))
    _, wp, _, ap, _, cp, tp = jax_modules(cfg, space, (3,), False)
    sd = world_model_from_flax(wp)
    twm, tact, tcrit, ttarget = port_modules(cfg, space, (3,), False, wp, ap, cp, tp)
    for module, want in ((twm, sd), (tact, actor_from_flax(ap)), (tcrit, critic_from_flax(cp))):
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the transposed convs: HWIO flipped in kH, kW, as [in, out, kH, kW]
    k = np.asarray(wp["params"]["cnn_decoder"]["ConvTranspose_0"]["kernel"])
    np.testing.assert_array_equal(sd["cnn_decoder.deconvs.0.weight"].numpy(), k[::-1, ::-1].transpose(2, 3, 0, 1))


MAIN_TINY = {"env.num_envs": 2, "buffer.size": 64, "algo.learning_starts": 8, "algo.total_steps": 24}


@pytest.mark.parametrize(
    "env, cnn, mlp",
    [("pixel_catcher", ("rgb",), ()), ("dummy_discrete", (), ("state",)), ("dummy_continuous", ("rgb",), ("state",))],
)
def test_main_trains_on_cpu(env, cnn, mlp, tmp_path):
    cfg = tiny_cfg(cnn, mlp, env=env, **MAIN_TINY, log_base_dir=str(tmp_path))
    fused_gru.reset_launch_count()
    out = tdv3.main(cfg, device="cpu")
    assert fused_gru.launch_count == 0
    # 12 updates of 2 envs; training from update 4 (learning_starts 8 / 2
    # envs): Ratio(1) gives 1 step at the first call, then one per env step
    assert out["env_steps"] == 24
    assert out["gradient_steps"] == 1 + 2 * 8
    assert list(out["metrics"]) == list(tdv3.METRIC_ORDER)
    assert all(np.isfinite(v) for v in out["metrics"].values())


def test_main_needs_cuda_without_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdv3.main(tiny_cfg(**MAIN_TINY, log_base_dir=str(tmp_path)))


# --------------------------------------------------------------------------- #
# main() through the env pipeline, and the faults of ROADMAP queue C
# --------------------------------------------------------------------------- #


def _scalar_tags(log_dir):
    (events,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    return {tag for _, tag, _ in read_scalars(events)}


def test_main_on_pixel_pendulum_repeats_actions(tmp_path, monkeypatch):
    """A tiny ``main`` on PixelPendulum through ``build_vector_env``
    (``sync``, as the env config asks) with ``env.action_repeat=2``: the
    base env steps twice a policy step, and the heartbeat counts those
    env steps, 2 x policy steps (queue C2); the test episode runs after
    training (queue C1)."""
    base_steps = [0]
    real_step = tjp.JittablePixelEnv.step

    def counted(self, action):
        base_steps[0] += 1
        return real_step(self, action)

    beats = []
    real_beat = tdv3.log_sps_and_heartbeat
    monkeypatch.setattr(tjp.JittablePixelEnv, "step", counted)
    monkeypatch.setattr(tdv3, "log_sps_and_heartbeat", lambda logger, **kw: (beats.append(kw), real_beat(logger, **kw)))
    cfg = tiny_cfg(("rgb",), (), env="pixel_pendulum", **MAIN_TINY, log_base_dir=str(tmp_path), **{"env.action_repeat": 2})
    assert tfactory.resolve_env_backend(cfg) == "sync"
    out = tdv3.main(cfg, device="cpu")
    assert out["env_steps"] == 24 and out["gradient_steps"] == 1 + 2 * 8
    train_base_steps = 2 * out["env_steps"]
    # PixelPendulum truncates at 200 raw steps: the test episode is 100 policy steps
    assert base_steps[0] == train_base_steps + 200
    assert sum(b["env_steps"] for b in beats) == train_base_steps
    assert beats[-1]["policy_step"] == out["env_steps"]
    assert out["test_cumulative_reward"] is not None and np.isfinite(out["test_cumulative_reward"])
    assert "Test/cumulative_reward" in _scalar_tags(out["log_dir"])


@pytest.mark.parametrize("case", ["run_test", "no_run_test", "preempted"])
def test_main_runs_the_test_episode_after_training(case, tmp_path, monkeypatch):
    """``algo.run_test`` (on by default) plays one episode after the loop
    and logs ``Test/cumulative_reward``, as the JAX main does
    (``dreamer_v3.py:1173-1174``); not when it is off, nor after a
    preemption (queue C1)."""
    played = []
    real_test = tdv3.test
    monkeypatch.setattr(tdv3, "test", lambda *a, **kw: played.append(1) or real_test(*a, **kw))
    cfg = tiny_cfg((), ("state",), **MAIN_TINY, log_base_dir=str(tmp_path), run_name="t", **{"algo.run_test": case != "no_run_test"})
    assert compose("XS")["algo"]["run_test"] is True
    if case == "preempted":
        polls = itertools.count(1)
        monkeypatch.setattr(manager.RunResilience, "preempt_requested", lambda self: next(polls) >= 7)
        with pytest.raises(SystemExit):
            tdv3.main(cfg, device="cpu")
        (log_dir,) = glob.glob(os.path.join(str(tmp_path), "dreamer_v3", "dummy_discrete", "t", "version_*"))
    else:
        log_dir = tdv3.main(cfg, device="cpu")["log_dir"]
    assert played == ([1] if case == "run_test" else [])
    assert ("Test/cumulative_reward" in _scalar_tags(log_dir)) == (case == "run_test")


class FlakyPixelCatcher:
    """A port PixelCatcher whose third ``step`` raises, once per test (the
    env ``_target_`` of the restart drill)."""

    crashed = False

    def __new__(cls, **kwargs):
        from sheeprl_tpu_torch.envs.toy import PixelCatcher

        env = PixelCatcher(**kwargs)
        real, calls = env.step, [0]

        def step(action):
            calls[0] += 1
            if calls[0] == 3 and not FlakyPixelCatcher.crashed:
                FlakyPixelCatcher.crashed = True
                raise RuntimeError("env crash")
            return real(action)

        env.step = step
        return env


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_restart_drill_amends_the_last_step(ring, tmp_path, monkeypatch):
    """Env 0 raises at its third step: ``RestartOnException`` recreates it,
    and the loop rewrites the last stored step of env 0 to a truncation
    (``truncated`` 1, ``terminated`` 0, ``is_first`` 0) and starts the next
    with ``is_first`` 1 (JAX ``dreamer_v3.py:869-882``): on the ring through
    ``amend_last``, on the host buffer by the same index patch."""
    monkeypatch.setattr(FlakyPixelCatcher, "crashed", False)
    monkeypatch.setattr(tw.RestartOnException, "sleep", staticmethod(lambda s: None))
    buffers = []
    real_make = tdv3.make_sequential_replay
    monkeypatch.setattr(tdv3, "make_sequential_replay", lambda *a, **kw: buffers.append(real_make(*a, **kw)) or buffers[-1])
    cfg = tiny_cfg(
        ("rgb",),
        (),
        env="pixel_catcher",
        **MAIN_TINY,
        log_base_dir=str(tmp_path),
        **{"env.backend": "sync", "buffer.device": ring, "algo.run_test": False, "env.max_episode_steps": 50},
    )
    cfg.env.wrapper["_target_"] = f"{__name__}.FlakyPixelCatcher"
    with pytest.warns(UserWarning, match="Restarting env after crash"):
        tdv3.main(cfg, device="cpu")
    assert FlakyPixelCatcher.crashed
    (rb,) = buffers
    if ring:
        assert isinstance(rb, tdb.DeviceReplayBuffer)
        flags = {k: rb._bufs[k][0, :4, 0].numpy() for k in ("terminated", "truncated", "is_first")}
    else:
        flags = {k: np.asarray(rb.buffer[0][k])[:4].reshape(-1) for k in ("terminated", "truncated", "is_first")}
    # rows 0-2 hold policy steps 1-3 (step 3 crashed), row 3 the restart's first obs
    np.testing.assert_array_equal(flags["truncated"], [0, 0, 1, 0])
    np.testing.assert_array_equal(flags["terminated"], [0, 0, 0, 0])
    np.testing.assert_array_equal(flags["is_first"], [1, 0, 0, 1])


def test_amend_last_matches_jax():
    """The ring's ``amend_last`` rewrites the same slot to the same flags as
    the JAX ring's, at an unwrapped and a wrapped cursor."""
    rng = np.random.default_rng(0)
    jring = jdb.DeviceReplayBuffer(5, n_envs=2, obs_keys=("state",), seed=1)
    tring = tdb.DeviceReplayBuffer(5, n_envs=2, obs_keys=("state",), device="cpu", seed=1)
    for i in range(8):
        step = {
            "state": rng.standard_normal((1, 2, 3)).astype(np.float32),
            "actions": rng.standard_normal((1, 2, 2)).astype(np.float32),
            **{k: (rng.random((1, 2, 1)) < 0.5).astype(np.float32) for k in ("rewards", "terminated", "truncated", "is_first")},
        }
        jring.add(step)
        tring.add(step)
        if i in (2, 7):
            for ring in (jring, tring):
                ring.amend_last(i % 2, terminated=0.0, truncated=1.0, is_first=0.0)
            for k in ("terminated", "truncated", "is_first"):
                np.testing.assert_array_equal(tring._bufs[k].numpy(), np.asarray(jring._bufs[k]))


# tests/test_torch_cli.py::TINY: a dry run on the CPU at tiny widths
CLI_TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=dummy_discrete",
    "fabric=cpu",
    "dry_run=True",
    "buffer.memmap=False",
    "algo.per_rank_batch_size=1",
    "algo.per_rank_sequence_length=1",
    "buffer.size=8",
    "algo.learning_starts=0",
    "algo.horizon=4",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.num_envs=2",
    "env.screen_size=16",
]


def _cli_argv(tmp_path, *extra):
    return CLI_TINY + [f"log_base_dir={tmp_path}", "run_name=auto", "metric.telemetry.enabled=True", *extra]


def test_cli_records_the_auto_resume_events(tmp_path, monkeypatch):
    """``checkpoint.resume_from=auto`` past a newest checkpoint that does
    not load: the CLI's run record says ``resume_fallbacks: 1`` and its
    telemetry holds one ``resume_fallback`` and one ``auto_resume`` event,
    the events the JAX package queues on the same directory (queue C3)."""
    from sheeprl_tpu.resilience import autoresume as jar
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.resilience.manifest import build_manifest
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    runs = tmp_path / "RUNS.jsonl"
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(runs))
    cli.run(_cli_argv(tmp_path))
    base = tmp_path / "dreamer_v3" / "dummy_discrete" / "auto"
    (good,) = glob.glob(str(base / "version_0" / "checkpoint" / "*.ckpt"))
    torn = str(base / "version_0" / "checkpoint" / "ckpt_999_0.ckpt")
    save_checkpoint(torn, {"update": 999}, manifest=build_manifest(step=999, backend="pickle", world_size=1, state={"update": 999}))
    with open(torn, "wb") as f:
        f.write(b"\x00torn")
    # the JAX package on the same directory
    jcfg = dotdict({"log_base_dir": str(tmp_path), "root_dir": "dreamer_v3/dummy_discrete", "run_name": "auto", "fabric": {"devices": 1}})
    jar._pending_events.clear()
    with pytest.warns(UserWarning, match="falling back"):
        assert jar.resolve_auto_resume(jcfg) == good
    want = [(kind, fields["path"]) for kind, fields in jar._pending_events]
    jar._pending_events.clear()
    assert want == [("resume_fallback", torn), ("auto_resume", good)]
    with pytest.warns(UserWarning, match="falling back"):
        cli.run(_cli_argv(tmp_path, "checkpoint.resume_from=auto"))
    records = [json.loads(line) for line in runs.read_text().splitlines()]
    assert [r["resume_fallbacks"] for r in records] == [0, 1]
    stream = [json.loads(line) for line in (base / "telemetry.jsonl").read_text().splitlines()]
    got = [(e["event"], e["path"]) for e in stream if e["event"] in ("resume_fallback", "auto_resume")]
    assert got == want


def test_saved_config_reads_back_in_pyyaml(tmp_path):
    """``config.yaml`` of every ``configs/exp/*.yaml`` that composes reads
    back through PyYAML (the JAX package's reader) and the port's reader
    with the composed values and types: floats keep a ``.`` and a signed
    exponent (queue C4)."""
    from sheeprl_tpu_torch.config.compose import compose as compose_tree, load_config_file

    def same(got, want, path):
        assert type(got) is type(want) or (isinstance(want, dict) and isinstance(got, dict)), (path, got, want)
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                same(got[k], want[k], f"{path}.{k}")
        elif isinstance(want, list):
            assert len(got) == len(want), path
            for i, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"{path}[{i}]")
        else:
            assert got == want, (path, got, want)

    composed = 0
    for path in sorted(glob.glob(os.path.join(os.path.dirname(tdv3.__file__), "..", "..", "configs", "exp", "*.yaml"))):
        name = os.path.basename(path)[:-5]
        try:
            cfg = compose_tree("config", [f"exp={name}"]).to_dict()
        except Exception:
            continue  # an exp with a mandatory value to set on the command line
        composed += 1
        save_configs(cfg, str(tmp_path / name))
        text = (tmp_path / name / "config.yaml").read_text()
        same(yaml.safe_load(text), cfg, name)
        same(load_config_file(str(tmp_path / name / "config.yaml")).to_dict(), cfg, name)
        assert not re.search(r"[:\[,]\s*-?\d+e[-+]?\d", text), name  # no float without a "."
    assert composed >= 40
