"""The port's Dreamer-V3 acting path (sheeprl_tpu_torch/algos/dreamer_v3)
against the JAX package's, module by module and as a whole.

Weights are made by the JAX package's own init, shifted by seeded numpy
noise so no LayerNorm scale or bias is trivial, then carried across with
``convert``; inputs are made with numpy from a seed and fed to both. All
comparisons are fp32 on the CPU. Tolerances:

- ``MOD_TOL`` 1e-5 on a module's outputs: the two frameworks sum in another
  order, and flax's LayerNorm takes the variance as E[x^2]-E[x]^2 where the
  port's is two-pass (rounding of order 1e-7 relative, amplified by the
  normalisation);
- ``ENC_TOL`` 5e-5 on the CNN encoder's features: four conv + LayerNorm
  stages of the same differences, on features of order 1;
- one-hot latents (z by mode) and greedy actions must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as nn

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3.utils import prepare_obs as jax_prepare_obs
from sheeprl_tpu.envs.toy import PixelCatcher as JaxPixelCatcher
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3.convert import actor_from_flax, world_model_from_flax
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate
from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action, prepare_obs
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.toy import PixelCatcher
from sheeprl_tpu_torch.ops import fused_gru

MOD_TOL = 1e-5
ENC_TOL = 5e-5

TINY = {
    "algo.dense_units": 16,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 4,
    "algo.world_model.recurrent_model.recurrent_state_size": 16,
    "algo.world_model.transition_model.hidden_size": 12,
    "algo.world_model.representation_model.hidden_size": 12,
    "algo.world_model.stochastic_size": 4,
    "algo.world_model.discrete_size": 4,
    "env.screen_size": 16,
    "env.num_envs": 3,
}


def tiny_cfg(cnn=("rgb",), mlp=(), env="pixel_catcher", fused="auto", **extra):
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


def jax_world_model(cfg, space, actions_dim, seed=0):
    """The JAX WorldModel with the port's config, its params (perturbed)."""
    algo, wm_cfg = cfg["algo"], cfg["algo"]["world_model"]
    cnn, mlp = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    screen = cfg["env"]["screen_size"]
    wm = jagent.WorldModel(
        cnn_keys=cnn,
        mlp_keys=mlp,
        cnn_output_channels=tuple(3 for _ in cnn),
        mlp_output_dims=tuple(space[k].shape[0] for k in mlp),
        image_size=(screen, screen),
        actions_dim=tuple(actions_dim),
        stochastic_size=wm_cfg["stochastic_size"],
        discrete_size=wm_cfg["discrete_size"],
        unimix=algo["unimix"],
        recurrent_state_size=wm_cfg["recurrent_model"]["recurrent_state_size"],
        recurrent_dense_units=wm_cfg["recurrent_model"]["dense_units"],
        encoder_cnn_multiplier=wm_cfg["encoder"]["cnn_channels_multiplier"],
        encoder_mlp_layers=wm_cfg["encoder"]["mlp_layers"],
        encoder_dense_units=wm_cfg["encoder"]["dense_units"],
        decoder_cnn_multiplier=wm_cfg["observation_model"]["cnn_channels_multiplier"],
        decoder_mlp_layers=wm_cfg["observation_model"]["mlp_layers"],
        decoder_dense_units=wm_cfg["observation_model"]["dense_units"],
        representation_hidden_size=wm_cfg["representation_model"]["hidden_size"],
        transition_hidden_size=wm_cfg["transition_model"]["hidden_size"],
        reward_bins=wm_cfg["reward_model"]["bins"],
        reward_layers=wm_cfg["reward_model"]["mlp_layers"],
        reward_dense_units=wm_cfg["reward_model"]["dense_units"],
        continue_layers=wm_cfg["discount_model"]["mlp_layers"],
        continue_dense_units=wm_cfg["discount_model"]["dense_units"],
        cnn_stages=int(np.log2(screen) - 2),
        fused_recurrent="flax",
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

    return wm, _perturb(nn.init(init, wm)(jax.random.PRNGKey(seed)), seed)


def jax_actor(cfg, latent, actions_dim, is_continuous, seed=0):
    a = cfg["algo"]["actor"]
    actor = jagent.Actor(
        latent_state_size=latent,
        actions_dim=tuple(actions_dim),
        is_continuous=is_continuous,
        init_std=a["init_std"],
        min_std=a["min_std"],
        max_std=a["max_std"],
        dense_units=a["dense_units"],
        mlp_layers=a["mlp_layers"],
        unimix=cfg["algo"]["unimix"],
        action_clip=a["action_clip"],
    )
    return actor, _perturb(actor.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, latent))), seed + 1)


def pair(cnn=("rgb",), mlp=(), actions_dim=(3,), is_continuous=False, fused="auto", seed=0):
    """(cfg, jax wm, wm params, jax actor, actor params, port wm, port actor, port player)."""
    cfg = tiny_cfg(cnn, mlp, fused=fused)
    space = obs_space(cnn, mlp)
    jwm, jwp = jax_world_model(cfg, space, actions_dim, seed)
    jact, jap = jax_actor(cfg, jwm.latent_state_size, actions_dim, is_continuous, seed)
    wm_sd = world_model_from_flax(jwp)
    twm, tact, player = tagent.build_agent(
        actions_dim, is_continuous, cfg, space, wm_sd, actor_from_flax(jap), device="cpu"
    )
    return cfg, jwm, jwp, jact, jap, twm, tact, player


def rand_obs(cnn, mlp, batch, seed):
    rng = np.random.default_rng(seed)
    o = {k: rng.integers(0, 256, (batch, 16, 16, 3)).astype(np.uint8) for k in cnn}
    o.update({k: (3 * rng.standard_normal((batch, 5))).astype(np.float32) for k in mlp})
    return o


def t(a):
    return torch.as_tensor(np.asarray(a))


KEYSETS = [(("rgb",), ()), ((), ("state",)), (("rgb",), ("state",))]


@pytest.mark.parametrize("cnn, mlp", KEYSETS)
def test_encode_matches(cnn, mlp):
    cfg, jwm, jwp, *_, twm, _, _ = pair(cnn, mlp)
    obs = rand_obs(cnn, mlp, 4, 1)
    want = np.asarray(jwm.apply(jwp, obs, method=jagent.WorldModel.encode))
    got = twm.encode({k: t(v) for k, v in obs.items()}).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ENC_TOL if cnn else MOD_TOL, rtol=ENC_TOL)


def test_initial_state_matches():
    _, jwm, jwp, *_, twm, _, _ = pair()
    h_j, z_j = jwm.apply(jwp, (3,), method=jagent.WorldModel.initial_state)
    h_t, z_t = twm.initial_state(3)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), atol=MOD_TOL, rtol=MOD_TOL)
    np.testing.assert_array_equal(z_t.detach().numpy(), np.asarray(z_j))


def _jax_observe_mode(m, z, h, action, obs):
    """JAX observe_step with the posterior's mode in place of a sample."""
    embedded = m.encode(obs)
    h = m.recurrent_model(jnp.concatenate([z, action], -1), h)
    logits = jagent._uniform_mix(
        m.representation_model(jnp.concatenate([h, embedded], -1)), m.discrete_size, m.unimix
    )
    return jagent.compute_stochastic_state(logits, None, sample=False), h, logits


@pytest.mark.parametrize("fused", ["auto", "flax"])
@pytest.mark.parametrize("cnn, mlp", KEYSETS)
def test_observe_step_mode_matches(fused, cnn, mlp):
    _, jwm, jwp, *_, twm, _, _ = pair(cnn, mlp, fused=fused)
    assert twm.fused is (fused == "auto")
    rng = np.random.default_rng(2)
    b, s, d = 4, 4, 4
    h = rng.standard_normal((b, 16)).astype(np.float32)
    z = np.eye(d, dtype=np.float32)[rng.integers(0, d, (b, s))].reshape(b, s * d)
    a = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
    obs = rand_obs(cnn, mlp, b, 3)
    z_j, h_j, _ = jwm.apply(jwp, z, h, a, obs, method=_jax_observe_mode)
    z_t, h_t = twm.observe_step(t(z), t(h), t(a), {k: t(v) for k, v in obs.items()}, sample=False)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), atol=MOD_TOL, rtol=MOD_TOL)
    np.testing.assert_array_equal(z_t.detach().numpy(), np.asarray(z_j))


ACTOR_CASES = [((3,), False), ((3, 2), False), ((2,), True)]


@pytest.mark.parametrize("actions_dim, is_continuous", ACTOR_CASES)
def test_actor_heads_and_distributions_match(actions_dim, is_continuous):
    *_, jact, jap, twm, tact, _ = pair(actions_dim=actions_dim, is_continuous=is_continuous)
    rng = np.random.default_rng(4)
    latent = rng.standard_normal((5, twm.latent_state_size)).astype(np.float32)
    heads_j = jact.apply(jap, latent)
    heads_t = tact(t(latent))
    for a, b in zip(heads_t, heads_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=MOD_TOL, rtol=MOD_TOL)
    dists_j = jagent.actor_dists(jact, heads_j)
    dists_t = tagent.actor_dists(tact, heads_t)
    if is_continuous:
        dj, dt = dists_j[0].base, dists_t[0].base
        np.testing.assert_allclose(dt.loc.detach().numpy(), np.asarray(dj.loc), atol=MOD_TOL, rtol=MOD_TOL)
        np.testing.assert_allclose(dt.scale.detach().numpy(), np.asarray(dj.scale), atol=MOD_TOL, rtol=MOD_TOL)
        actions = rng.uniform(-1, 1, (5, sum(actions_dim))).astype(np.float32)
        pairs = [(dists_t[0], dists_j[0], actions)]
    else:
        splits = np.cumsum(actions_dim)[:-1]
        onehots = [np.eye(n, dtype=np.float32)[rng.integers(0, n, 5)] for n in actions_dim]
        pairs = list(zip(dists_t, dists_j, onehots))
        for dt, dj in zip(dists_t, dists_j):
            np.testing.assert_allclose(dt.probs.detach().numpy(), np.asarray(dj.probs), atol=MOD_TOL, rtol=MOD_TOL)
        assert len(np.split(np.concatenate(onehots, -1), splits, axis=-1)) == len(actions_dim)
    for dt, dj, act in pairs:
        np.testing.assert_allclose(
            dt.log_prob(t(act)).detach().numpy(), np.asarray(dj.log_prob(act)), atol=MOD_TOL, rtol=MOD_TOL
        )
        np.testing.assert_allclose(dt.entropy().detach().numpy(), np.asarray(dj.entropy()), atol=MOD_TOL, rtol=MOD_TOL)


@pytest.mark.parametrize("actions_dim", [(3,), (3, 2)])
def test_greedy_discrete_actions_match(actions_dim):
    *_, jact, jap, twm, tact, _ = pair(actions_dim=actions_dim)
    latent = np.random.default_rng(5).standard_normal((6, twm.latent_state_size)).astype(np.float32)
    want = np.asarray(jagent.sample_actor_actions(jact, jap, latent, jax.random.PRNGKey(0), greedy=True))
    got = tagent.sample_actor_actions(tact, t(latent), greedy=True).detach().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("greedy", [True, False])
def test_continuous_actions_are_clipped_and_greedy_is_most_likely(greedy):
    *_, tact, _ = pair(actions_dim=(2,), is_continuous=True)
    tact.action_clip = 0.3
    latent = torch.randn(64, tact.mlp.linears[0].in_features, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    actions = tagent.sample_actor_actions(tact, latent, gen, greedy=greedy)
    assert actions.shape == (64, 2)
    assert float(actions.detach().abs().max()) <= 0.3 + 1e-6
    if greedy:
        # 100 candidates concentrate near tanh(mean): closer than a single draw
        loc = tagent.actor_dists(tact, tact(latent))[0].base.loc.clamp(-0.3, 0.3)
        single = tagent.sample_actor_actions(tact, latent, torch.Generator().manual_seed(1), greedy=False)
        assert (actions - loc).abs().mean() < (single - loc).abs().mean()


def test_prepare_obs_matches():
    rng = np.random.default_rng(6)
    obs = {
        "rgb": rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8),
        "stack": rng.integers(0, 256, (2, 4, 8, 8, 1)).astype(np.uint8),
        "state": rng.standard_normal((2, 3, 2)).astype(np.float32),
    }
    got = prepare_obs(obs, cnn_keys=("rgb", "stack"), num_envs=2)
    want = jax_prepare_obs(obs, cnn_keys=("rgb", "stack"), num_envs=2)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    single = prepare_obs({"rgb": obs["rgb"][0]}, cnn_keys=("rgb",))
    np.testing.assert_array_equal(single["rgb"], jax_prepare_obs({"rgb": obs["rgb"][0]}, cnn_keys=("rgb",))["rgb"])


@pytest.mark.parametrize("fused", ["auto", "flax"])
def test_player_slice_matches_jax_step_by_step(fused, monkeypatch):
    """T = 8 player steps through both packages on PixelCatcher frames, z by
    mode and greedy actions, with a masked reset of one env midway: h, z and
    the actions agree at every step."""
    T, n = 8, 3
    cfg, jwm, jwp, jact, jap, twm, tact, player = pair(fused=fused)
    # the JAX player's own step, with the posterior's mode in place of a sample
    orig = jagent.compute_stochastic_state
    monkeypatch.setattr(jagent, "compute_stochastic_state", lambda logits, key, sample=True: orig(logits, None, False))
    jplayer = jagent.PlayerDV3(jwm, jwp, jact, jap, (3,), n)
    envs = [PixelCatcher(size=16, seed=10 + i) for i in range(n)]
    frames = [e.reset(seed=10 + i)[0] for i, e in enumerate(envs)]
    jplayer.init_states()
    player.init_states()
    for step in range(T):
        if step == 4:
            jplayer.init_states([1])
            player.init_states([1])
            np.testing.assert_allclose(player.h.numpy(), np.asarray(jplayer.h), atol=MOD_TOL, rtol=MOD_TOL)
        obs = prepare_obs({"rgb": np.stack([f["rgb"] for f in frames])}, ("rgb",), n)
        a_j = jplayer.get_actions(obs, jax.random.PRNGKey(step), greedy=True)
        a_t = player.get_actions(obs, greedy=True, sample_state=False)
        np.testing.assert_allclose(player.h.numpy(), np.asarray(jplayer.h), atol=MOD_TOL, rtol=MOD_TOL)
        np.testing.assert_array_equal(player.z.numpy(), np.asarray(jplayer.z))
        np.testing.assert_array_equal(a_t, a_j)
        frames = [e.step(env_action(a, (3,), False))[0] for e, a in zip(envs, a_t)]


def test_player_sampling_is_seeded():
    *_, player = pair()
    obs = prepare_obs(rand_obs(("rgb",), (), 3, 7), ("rgb",), 3)

    def run(seed):
        player.init_states()
        gen = torch.Generator().manual_seed(seed)
        return [player.get_actions(obs, gen) for _ in range(3)], player.z.clone()

    (a1, z1), (a2, z2) = run(3), run(3)
    for x, y in zip(a1, a2):
        np.testing.assert_array_equal(x, y)
    torch.testing.assert_close(z1, z2)
    assert all(np.all(a.sum(-1) == 1) for a in a1)


def test_converter_lists_unported_leaves_and_rejects_unknown_ones():
    cfg = tiny_cfg()
    _, jwp = jax_world_model(cfg, obs_space(("rgb",), ()), (3,))
    # the decoders and the reward and continue heads are ported now
    sd = world_model_from_flax(jwp)
    assert {k.split(".")[0] for k in sd} >= {"cnn_decoder", "reward_model", "continue_model"}
    assert "recurrent_model.gru.kernel" in sd and sd["recurrent_model.gru.kernel"].shape == (16 + 16, 48)
    # flax conv HWIO -> torch OIHW; Dense [in, out] -> Linear [out, in]
    hwio = np.asarray(jwp["params"]["cnn_encoder"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(sd["cnn_encoder.convs.0.weight"].numpy(), hwio.transpose(3, 2, 0, 1))
    dense = np.asarray(jwp["params"]["transition_model"]["layers_1"]["kernel"])
    np.testing.assert_array_equal(sd["transition_model.1.weight"].numpy(), dense.T)
    bad = jax.tree.map(lambda a: a, jwp)
    bad["params"]["surprise"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="surprise"):
        world_model_from_flax(bad)


def test_build_agent_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tagent.build_agent((3,), False, tiny_cfg(), obs_space(("rgb",), ()))


def test_build_agent_seeded_init_is_reproducible():
    cfg = tiny_cfg()
    a = tagent.build_agent((3,), False, cfg, obs_space(("rgb",), ()), device="cpu")
    b = tagent.build_agent((3,), False, cfg, obs_space(("rgb",), ()), device="cpu")
    for (k, x), (_, y) in zip(a[0].state_dict().items(), b[0].state_dict().items()):
        torch.testing.assert_close(x, y, msg=k)


@pytest.mark.parametrize(
    "env, cnn, mlp",
    [("pixel_catcher", ("rgb",), ()), ("dummy_discrete", (), ("state",)), ("dummy_continuous", ("rgb",), ("state",))],
)
def test_evaluate_runs_on_cpu(env, cnn, mlp):
    cfg = compose(
        "XS",
        env=env,
        overrides={**TINY, "algo.cnn_keys.encoder": list(cnn), "algo.mlp_keys.encoder": list(mlp), "env.max_episode_steps": 12},
    )
    before = fused_gru.launch_count
    reward, steps = evaluate(cfg, device="cpu")
    assert 1 <= steps <= 12 and np.isfinite(reward)
    assert fused_gru.launch_count == before  # the plain version ran on the CPU tensors


def test_evaluate_loads_converted_weights():
    cfg, jwm, jwp, jact, jap, *_ = pair()
    state = {"world_model": world_model_from_flax(jwp), "actor": actor_from_flax(jap)}
    cfg = dict(cfg, env=dict(cfg["env"], max_episode_steps=5))
    assert evaluate(cfg, state, device="cpu")[1] <= 5


def test_jax_and_port_pixel_catcher_feed_the_same_frames():
    a, b = PixelCatcher(size=16, seed=3), JaxPixelCatcher(size=16, seed=3)
    np.testing.assert_array_equal(a.reset(seed=3)[0]["rgb"], b.reset(seed=3)[0]["rgb"])
