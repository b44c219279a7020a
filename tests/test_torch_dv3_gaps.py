"""Dreamer-V3's last one-card gaps in the port, against itself and the JAX
package on the CPU:

- ``bf16-true``: the JAX Dreamer-V3 modules fix fp32 parameters
  (``param_dtype=jnp.float32``) and read only the compute dtype, so a step
  at ``bf16-true`` is the step at ``bf16-mixed``. The port's is bit-equal to
  its own ``bf16-mixed`` step, and within the bounds of
  ``tests/test_torch_precision.py`` of the JAX ``local_train`` at
  ``bf16-true``;
- decoder keys other than the encoder's (``exp=dreamer_v3_XL_crafter``'s
  shape: an MLP encoder key and no MLP decoder key): one fp32 train step
  within ``TOL`` (metrics) and ``GRAD_TOL`` (gradients) of JAX;
- a JAX checkpoint that holds the replay buffer (the host buffer of
  sequences, memmapped or not, and the device ring), written by the JAX
  ``save_checkpoint``, loads in the port and gathers the same windows bit
  for bit; a memmapped one whose files are gone raises;
- the MineDojo actor's masked sampling: greedy exact, sampled actions equal
  given the same uniforms (the JAX draws injected), on random masks that
  reach the CRAFT, equip/place and destroy branches.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jdv3
from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.data import device_buffer as jdb
from sheeprl_tpu.ops import math as jm
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu.utils.utils import dotdict
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.convert import actor_from_flax, critic_from_flax, world_model_from_flax
from sheeprl_tpu_torch.data import buffers as tb
from sheeprl_tpu_torch.data import device_buffer as tdb
from sheeprl_tpu_torch.ops import math as tm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_dv3_train import (  # noqa: F401  (deterministic is a fixture)
    GRAD_TOL,
    TOL,
    _jax_tx,
    _perturb,
    _recording,
    batch,
    deterministic,
    obs_space,
    port_modules,
    t,
    tiny_cfg,
)
from tests.test_torch_precision import EPS, FP32_SUMMED, TRAIN_GRAD_TOL, TRAIN_TOL, _jax_train, grad_err, rel_err

# --------------------------------------------------------------------------- #
# bf16-true
# --------------------------------------------------------------------------- #


def _jax_agent(cfg, space, actions_dim, is_continuous, precision):
    fabric = JaxFabric(devices=1, precision=precision, accelerator="cpu")
    wm, wp, actor, ap, critic, cp, _, _ = jagent.build_agent(fabric, actions_dim, is_continuous, cfg, space)
    return wm, _perturb(wp, 0), actor, _perturb(ap, 1), critic, _perturb(cp, 2), _perturb(cp, 3)


def _port_step(cfg, space, params, d, actions_dim=(3,), is_continuous=False):
    twm, tact, tcrit, ttarget = port_modules(cfg, space, actions_dim, is_continuous, *params)
    opts = tdv3.build_optimizers(cfg, twm, tact, tcrit)
    step = tdv3.make_train_step(twm, tact, tcrit, ttarget, *opts, cfg, is_continuous)
    grads = {}
    moments, metrics = step(tm.init_moments(), {k: t(v) for k, v in d.items()}, None, grads)
    return (twm, tact, tcrit), metrics, grads, moments


def test_bf16_true_step_is_bit_equal_to_bf16_mixed(deterministic):
    space = obs_space(("rgb",), ("state",))
    cfgs = {p: tiny_cfg(**{"fabric.precision": p}) for p in ("bf16-mixed", "bf16-true")}
    _, wp, _, ap, _, cp, tp = _jax_agent(cfgs["bf16-mixed"], space, (3,), False, "bf16-mixed")
    d = batch(("rgb",), ("state",), (3,), False, seed=11)
    out = {p: _port_step(cfg, space, (wp, ap, cp, tp), d) for p, cfg in cfgs.items()}
    (m_mods, m_metrics, m_grads, m_mom), (t_mods, t_metrics, t_grads, t_mom) = out["bf16-mixed"], out["bf16-true"]
    assert t_mods[0].dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in t_mods[0].parameters())
    assert torch.equal(t_metrics, m_metrics)
    assert torch.equal(t_mom.low, m_mom.low) and torch.equal(t_mom.high, m_mom.high)
    for name in m_grads:
        assert all(torch.equal(a, b) for a, b in zip(t_grads[name], m_grads[name])), name
    for a, b in zip(t_mods, m_mods):
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_bf16_true_step_matches_jax_local_train(deterministic):
    cfg = tiny_cfg(**{"fabric.precision": "bf16-true"})
    jcfg = tiny_cfg(**{"fabric.precision": "bf16-true", "algo.world_model.recurrent_model.fused": "pallas"})
    space = obs_space(("rgb",), ("state",))
    jwm, wp, jact, ap, jcrit, cp, tp = _jax_agent(jcfg, space, (3,), False, "bf16-true")
    # JAX's Dreamer-V3 at bf16-true: bf16 compute, fp32 params
    assert jwm.dtype == jnp.bfloat16 and all(np.asarray(x).dtype == np.float32 for x in jax.tree.leaves(wp))
    d = batch(("rgb",), ("state",), (3,), False, seed=11)
    j_metrics, j_grads, j_moments = _jax_train(jwm, jact, jcrit, (wp, ap, cp, tp), jcfg, d, False, (3,))
    fp32 = (jwm.clone(dtype=jnp.float32), jact.clone(dtype=jnp.float32), jagent.make_critic(dict(jcfg["algo"]["critic"]), jnp.float32))
    j32_metrics, j32_grads, _ = _jax_train(*fp32, (wp, ap, cp, tp), jcfg, d, False, (3,))
    mods, t_metrics, grads, t_moments = _port_step(cfg, space, (wp, ap, cp, tp), d)
    wm_norm = tdv3.METRIC_ORDER.index("Grads/world_model")
    rest = [i for i in range(len(tdv3.METRIC_ORDER)) if i != wm_norm]
    assert rel_err(t_metrics[rest], j_metrics[rest]) <= TRAIN_TOL, rel_err(t_metrics[rest], j_metrics[rest]) / EPS
    assert rel_err(t_metrics[wm_norm], j32_metrics[wm_norm]) <= TRAIN_TOL
    assert rel_err(t_moments.low, j_moments.low) <= TRAIN_TOL
    for name, module in zip(("world_model", "actor", "critic"), mods):
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        for k, want in j_grads[name].items():
            if name == "world_model" and k == FP32_SUMMED:
                want = j32_grads[name][k]
            assert grad_err(got[k], want) <= TRAIN_GRAD_TOL, (name, k, grad_err(got[k], want) / EPS)


# --------------------------------------------------------------------------- #
# decoder keys other than the encoder's
# --------------------------------------------------------------------------- #


def test_decoder_keys_other_than_the_encoders_match_jax(deterministic):
    """cnn decoder [rgb], mlp decoder [] beside an mlp encoder key: the JAX
    decoders are built over the encoder keys with the decoder keys' sizes
    (an MLP decoder trunk with no head), and the reconstruction loss runs
    over the decoder keys only."""
    extra = {"algo.cnn_keys.decoder": ["rgb"], "algo.mlp_keys.decoder": []}
    cfg = tiny_cfg(**extra)
    jcfg = tiny_cfg(**extra, **{"algo.world_model.recurrent_model.fused": "flax"})
    space = obs_space(("rgb",), ("state",))
    jwm, wp, jact, ap, jcrit, cp, tp = _jax_agent(jcfg, space, (3,), False, "32-true")
    assert "head_state" not in wp["params"]["mlp_decoder"]
    algo = jcfg["algo"]
    txs = [_recording(_jax_tx(algo[k]["optimizer"], algo[k]["clip_gradients"])) for k in ("world_model", "actor", "critic")]
    fabric = types.SimpleNamespace(data_axis="data", world_size=1, model_axis=None)
    local_train, _ = jdv3.make_train_step(fabric, jwm, jact, jcrit, *txs, dotdict(jcfg), False, (3,))
    d = batch(("rgb",), ("state",), (3,), False, seed=11)
    opt_states = [tx.init(p) for tx, p in zip(txs, (wp, ap, cp))]
    out = jax.jit(local_train)(wp, ap, cp, tp, *opt_states, jm.init_moments(), {k: jnp.asarray(v) for k, v in d.items()}, jax.random.PRNGKey(0))
    *_, o_wm, o_actor, o_critic, _, j_metrics = out
    mods, t_metrics, grads, _ = _port_step(cfg, space, (wp, ap, cp, tp), d)
    assert len(mods[0].mlp_decoder.heads) == 0
    np.testing.assert_allclose(t_metrics[:10].numpy(), np.asarray(j_metrics)[:10], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t_metrics[10:].numpy(), np.asarray(j_metrics)[10:], atol=GRAD_TOL, rtol=GRAD_TOL)
    convert = (world_model_from_flax, actor_from_flax, critic_from_flax)
    for name, module, log, conv in zip(("world_model", "actor", "critic"), mods, (o_wm, o_actor, o_critic), convert):
        want = conv(log[1])
        got = dict(zip([n for n, _ in module.named_parameters()], grads[name]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"{name} {k}")


# --------------------------------------------------------------------------- #
# a JAX checkpoint that holds the replay buffer
# --------------------------------------------------------------------------- #

KEYS = ("rgb", "state")


def _steps(n_envs, n_steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        yield {
            "rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 3), dtype=np.uint8),
            "state": rng.standard_normal((1, n_envs, 3)).astype(np.float32),
            "actions": rng.standard_normal((1, n_envs, 2)).astype(np.float32),
            "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32),
            "terminated": (rng.random((1, n_envs, 1)) < 0.2).astype(np.float32),
            "truncated": np.zeros((1, n_envs, 1), np.float32),
            "is_first": np.zeros((1, n_envs, 1), np.float32),
        }


def _jax_host_buffer(tmp_path, memmap):
    rb = jb.EnvIndependentReplayBuffer(
        8, n_envs=3, obs_keys=KEYS, memmap=memmap, memmap_dir=tmp_path / "mm" if memmap else None, buffer_cls=jb.SequentialReplayBuffer, seed=5
    )
    for data in _steps(3, 11):
        rb.add(data)
    return rb


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
        assert g.dtype == np.asarray(want[k]).dtype


@pytest.mark.parametrize("memmap", [False, True])
def test_a_jax_host_buffer_in_a_checkpoint_gathers_the_same_windows(tmp_path, memmap):
    rb = _jax_host_buffer(tmp_path, memmap)
    path = str(tmp_path / "ckpt_8_0.ckpt")
    jax_save_checkpoint(path, {"rb": rb, "update": 8})
    state = load_checkpoint(path)
    got = state["rb"]
    assert isinstance(got, tb.EnvIndependentReplayBuffer) and all(isinstance(b, tb.SequentialReplayBuffer) for b in got.buffer)
    assert all(got.is_memmap) == memmap
    for _ in range(3):
        _equal(got.sample(4, sequence_length=3, n_samples=2), rb.sample(4, sequence_length=3, n_samples=2))
    # into the port's ring, as a run with buffer.device takes it
    ring = tdb.adapt_restored_buffer(got, True, seed=5, device="cpu")
    _equal(ring.host_arrays(), jdb.DeviceReplayBuffer.from_host_buffer(rb, seed=5).host_arrays())


def test_a_jax_memmapped_buffer_without_its_files_raises(tmp_path):
    rb = _jax_host_buffer(tmp_path, True)
    path = str(tmp_path / "ckpt_8_0.ckpt")
    jax_save_checkpoint(path, {"rb": rb, "update": 8})
    for f in (tmp_path / "mm").rglob("*.memmap"):
        f.unlink()
    with pytest.raises(FileNotFoundError, match="no longer exists"):
        load_checkpoint(path)


def test_a_jax_device_ring_in_a_checkpoint_gathers_the_same_windows(tmp_path):
    ring = jdb.DeviceReplayBuffer(8, n_envs=3, obs_keys=KEYS, seed=11)
    for data in _steps(3, 11, seed=1):
        ring.add(data)
    path = str(tmp_path / "ckpt_8_0.ckpt")
    jax_save_checkpoint(path, {"rb": ring, "update": 8})
    got = load_checkpoint(path)["rb"]
    assert isinstance(got, tdb.DeviceReplayBuffer)
    restored = tdb.adapt_restored_buffer(got, True, seed=11, device="cpu")
    _equal(restored.host_arrays(), ring.host_arrays())
    np.testing.assert_array_equal(restored._pos, ring._pos)
    for a, b in zip(restored.sample_batches(4, 3, 3), ring.sample_batches(4, 3, 3)):
        _equal(a, b)
    # and into the port's host buffer
    host = tdb.adapt_restored_buffer(load_checkpoint(path)["rb"], False)
    jhost = ring.to_host_buffer()
    for sub, jsub in zip(host.buffer, jhost.buffer):
        _equal({k: np.asarray(v) for k, v in sub.buffer.items()}, dict(jsub.buffer))


# --------------------------------------------------------------------------- #
# the MineDojo actor's masked sampling
# --------------------------------------------------------------------------- #

MINEDOJO_DIMS = (19, 6, 10)


def _minedojo(n=64, seed=0):
    cfg = tiny_cfg(**{"algo.actor.cls": "sheeprl_tpu.algos.dreamer_v3.agent.MinedojoActor"})
    jact = jagent.MinedojoActor(
        latent_state_size=20,
        actions_dim=MINEDOJO_DIMS,
        is_continuous=False,
        distribution="discrete",
        dense_units=8,
        mlp_layers=1,
        unimix=0.01,
    )
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((n, 20)).astype(np.float32)
    ap = _perturb(jact.init(jax.random.PRNGKey(seed), jnp.asarray(state)), seed)
    tact = tagent.MinedojoActor(20, MINEDOJO_DIMS, False, distribution="discrete", dense_units=8, mlp_layers=1, unimix=0.01)
    tact.load_state_dict(actor_from_flax(ap))
    # random masks, each allowing at least one choice; the action types
    # CRAFT, EQUIP, PLACE and DESTROY allowed often, so every branch runs
    m_type = rng.random((n, 19)) < 0.3
    m_type[:, [15, 16, 17, 18]] |= rng.random((n, 4)) < 0.8
    masks = {
        "mask_action_type": m_type,
        "mask_craft_smelt": rng.random((n, 6)) < 0.5,
        "mask_equip_place": rng.random((n, 10)) < 0.5,
        "mask_destroy": rng.random((n, 10)) < 0.5,
    }
    for k in ("mask_craft_smelt", "mask_equip_place", "mask_destroy"):
        masks[k][np.arange(n), rng.integers(0, masks[k].shape[1], n)] = True
    return cfg, jact, ap, tact, state, masks


def test_minedojo_masked_sampling_matches_jax(monkeypatch):
    _, jact, ap, tact, state, masks = _minedojo()
    jmask = {k: jnp.asarray(v) for k, v in masks.items()}
    tmask = {k: torch.as_tensor(v) for k, v in masks.items()}
    # greedy: exact
    j_greedy = np.asarray(jagent.sample_minedojo_actions(jact, ap, jnp.asarray(state), jax.random.PRNGKey(0), jmask, greedy=True))
    with torch.no_grad():
        t_greedy = tagent.sample_minedojo_actions(tact, t(state), None, tmask, greedy=True)
    np.testing.assert_array_equal(t_greedy.numpy(), j_greedy)
    # sampled: the JAX uniforms of each head's key, injected
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    uniforms = [
        torch.from_numpy(np.asarray(jax.random.uniform(k, (state.shape[0], d), jnp.float32, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
        for k, d in zip(keys, MINEDOJO_DIMS)
    ]
    monkeypatch.setattr(tagent, "_gumbel_uniform", lambda g, shape, dev: uniforms.pop(0))
    j_sample = np.asarray(jagent.sample_minedojo_actions(jact, ap, jnp.asarray(state), key, jmask))
    with torch.no_grad():
        t_sample = tagent.sample_minedojo_actions(tact, t(state), None, tmask)
    np.testing.assert_array_equal(t_sample.numpy(), j_sample)
    # every branch ran, and every sampled choice is allowed by its mask
    func = t_sample[:, :19].argmax(-1).numpy()
    craft = t_sample[:, 19:25].argmax(-1).numpy()
    item = t_sample[:, 25:].argmax(-1).numpy()
    assert {15, 16, 17, 18} <= set(func.tolist())
    assert masks["mask_action_type"][np.arange(len(func)), func].all()
    rows = func == 15
    assert masks["mask_craft_smelt"][rows, craft[rows]].all()
    rows = (func == 16) | (func == 17)
    assert masks["mask_equip_place"][rows, item[rows]].all()
    rows = func == 18
    assert masks["mask_destroy"][rows, item[rows]].all()


def test_minedojo_actor_is_built_and_the_player_takes_masks():
    cfg, *_ = _minedojo()
    cfg["env"]["num_envs"] = 2
    space = obs_space(("rgb",), ("state",))
    wm, actor, player = tagent.build_agent(MINEDOJO_DIMS, False, cfg, space, device="cpu")
    assert isinstance(actor, tagent.MinedojoActor)
    player.init_states()
    obs = {"rgb": np.zeros((2, 16, 16, 3), np.uint8), "state": np.zeros((2, 5), np.float32)}
    m_type = np.zeros((2, 19), bool)
    m_type[:, 3] = True
    mask = {"mask_action_type": m_type, "mask_craft_smelt": np.ones((2, 6), bool), "mask_equip_place": np.ones((2, 10), bool), "mask_destroy": np.ones((2, 10), bool)}
    actions = player.get_actions(obs, torch.Generator().manual_seed(0), mask=mask)
    assert actions.shape == (2, sum(MINEDOJO_DIMS)) and (actions[:, :19].argmax(-1) == 3).all()
