"""SAC-AE in the port against the JAX package on the CPU: the encoder (a
frame stack of pixels and a vector key) and the decoder (its flipped,
right-padded and cropped stride-2 ``ConvTranspose``), the actor and the Q
ensemble on the features, three gradient steps from counter 0 against the
JAX ``make_train_fn`` (the actor and EMA gates every second step, the
decoder every step: counters 0, 1 and 2 take both patterns), and ``python
-m sheeprl_tpu_torch exp=sac_ae env=pixel_pendulum`` on both replay paths
with ``cli_eval``.

Widths are tiny and frames 16 pixels a side in the module tests (``main``
forces 64). The jitted JAX step looks each Gaussian draw up by its key
(``tests/test_torch_sac.py::key_noise``); the port draws the actor's noise
only at the steps whose actor update runs.
"""

import copy
import functools
import glob
import json

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac_ae import agent as jagent
from sheeprl_tpu.algos.sac_ae import sac_ae as jsac_ae
from sheeprl_tpu.ops import optim as joptim
from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
from sheeprl_tpu.utils.utils import dotdict as jdotdict
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac import agent as tsac_agent
from sheeprl_tpu_torch.algos.sac.convert import from_flax, to_flax
from sheeprl_tpu_torch.algos.sac_ae import agent as tagent
from sheeprl_tpu_torch.algos.sac_ae import sac_ae as tsac_ae
from sheeprl_tpu_torch.algos.sac_ae.utils import preprocess_target
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_sac import FWD_TOL, PARAM_TOL, _shift, close, key_noise, step_keys, t

SCREEN, STACK, STATE, ACT, BATCH = 16, 3, 4, 1, 4


def ae_cfg():
    adam = {"lr": 1e-3, "eps": 1e-8, "betas": [0.9, 0.999]}
    net = {"dense_units": 8, "mlp_layers": 2, "dense_act": "relu", "layer_norm": True, "cnn_channels_multiplier": 1}
    return {
        "seed": 5,
        "fabric": {"precision": "32-true"},
        "env": {"screen_size": SCREEN, "num_envs": 1},
        "buffer": {"sample_next_obs": False},
        "algo": {
            "gamma": 0.99,
            "tau": 0.01,
            "hidden_size": 16,
            "cnn_keys": {"encoder": ["rgb"], "decoder": ["rgb"]},
            "mlp_keys": {"encoder": ["state"], "decoder": ["state"]},
            "encoder": {"tau": 0.05, "features_dim": 8, **net, "optimizer": dict(adam)},
            "decoder": {"l2_lambda": 1e-3, "per_rank_update_freq": 1, **net, "optimizer": {**adam, "weight_decay": 1e-2}},
            "actor": {"per_rank_update_freq": 2, "optimizer": dict(adam)},
            "critic": {"n": 2, "per_rank_target_network_update_freq": 2, "optimizer": dict(adam)},
            "alpha": {"alpha": 0.1, "optimizer": {**adam, "betas": [0.5, 0.999]}},
            "gradient_steps_chunk": 3,
        },
    }


def _spaces():
    rgb, state = (STACK, SCREEN, SCREEN, 3), (STATE,)
    j = gymnasium.spaces.Dict({"rgb": gymnasium.spaces.Box(0, 255, rgb, np.uint8), "state": gymnasium.spaces.Box(-np.inf, np.inf, state, np.float32)})
    p = spaces.Dict({"rgb": spaces.Box(0, 255, rgb, np.uint8), "state": spaces.Box(-np.inf, np.inf, state, np.float32)})
    return (j, gymnasium.spaces.Box(-2.0, 2.0, (ACT,), np.float32)), (p, spaces.Box(-2.0, 2.0, (ACT,), np.float32))


@functools.lru_cache(maxsize=None)
def _jax_agent(cfg_json):
    """The JAX ``build_agent``'s agent of a config, built once a process."""
    cfg = json.loads(cfg_json)
    (jobs, jact), _ = _spaces()
    return jagent.build_agent(JaxFabric(devices=1, precision=cfg["fabric"]["precision"], accelerator="cpu"), (ACT,), True, jdotdict(cfg), jobs, jact)[0]


def ae_pair(cfg):
    _, (pobs, pact) = _spaces()
    jag = copy.copy(_jax_agent(json.dumps(cfg, sort_keys=True)))
    for i, name in enumerate(("encoder_params", "decoder_params", "actor_params", "qfs_params")):
        setattr(jag, name, _shift(jax.device_get(getattr(jag, name)), 20 + i))
    jag.target_encoder_params = _shift(jax.device_get(jag.encoder_params), 30)
    jag.target_qfs_params = _shift(jax.device_get(jag.qfs_params), 31)
    state = {
        "encoder": jag.encoder_params,
        "decoder": jag.decoder_params,
        "actor": jag.actor_params,
        "qfs": jag.qfs_params,
        "target_encoder": jag.target_encoder_params,
        "target_qfs": jag.target_qfs_params,
        "log_alpha": np.asarray(jag.log_alpha),
    }
    tag, player = tagent.build_agent(cfg, pobs, pact, state, device="cpu")
    return jag, tag, player


def _raw(n, seed, g=None):
    rng = np.random.default_rng(seed)
    lead = (n,) if g is None else (g, n)
    return {
        "rgb": rng.integers(0, 256, (*lead, STACK, SCREEN, SCREEN, 3)).astype(np.uint8),
        "state": rng.standard_normal((*lead, STATE)).astype(np.float32),
    }


def _jax_obs(raw):
    """The JAX package's encoder input: the stack folded, /255."""
    rgb = raw["rgb"]
    b = rgb.shape[0]
    folded = np.moveaxis(rgb, 1, 3).reshape(b, SCREEN, SCREEN, STACK * 3)
    return {"rgb": folded.astype(np.float32) / 255.0, "state": raw["state"]}


def test_encoder_decoder_actor_and_q_ensemble_match_jax():
    cfg = ae_cfg()
    jag, tag, _ = ae_pair(cfg)
    raw = _raw(BATCH, 1)
    feat = jax.jit(jag.encoder.apply)(jag.encoder_params, _jax_obs(raw))
    tfeat = tag.encoder(tagent.encoder_inputs({k: t(v) for k, v in raw.items()}, ("rgb",), ("state",)))
    close(tfeat, feat, FWD_TOL, "features")
    recon = jax.jit(jag.decoder.apply)(jag.decoder_params, feat)
    trecon = tag.decoder(t(feat))
    close(trecon["rgb"].permute(0, 2, 3, 1), recon["rgb"], FWD_TOL, "pixels")
    close(trecon["state"], recon["state"], FWD_TOL, "state")
    mean, log_std = jag.actor.apply(jag.actor_params, feat)
    tmean, tlog_std = tag.actor(t(feat))
    close(tmean, mean, FWD_TOL, "mean")
    close(tlog_std, log_std, FWD_TOL, "tanh log-std")
    act = np.random.default_rng(2).uniform(-2, 2, (BATCH, ACT)).astype(np.float32)
    close(tag.qf(t(feat), t(act)), jagent.qf_ensemble_apply(jag.qf, jag.qfs_params, feat, act), FWD_TOL, "q")
    close(tsac_agent.actor_greedy_action(tag.actor, t(feat)), jagent.actor_greedy_action(jag.actor, jag.actor_params, feat), FWD_TOL, "greedy")
    # every leaf back to the JAX tree, the flipped deconvolution kernels too
    back = to_flax(tag.decoder, dict(tag.decoder.named_parameters()))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jag.decoder_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reconstruction_target_is_the_5_bit_quantization():
    x = torch.arange(256, dtype=torch.uint8)
    want = np.floor(np.arange(256) / 8.0) / 32 + 0.5 / 32 - 0.5
    np.testing.assert_allclose(preprocess_target(x).numpy(), want, atol=1e-7)


def test_three_steps_from_counter_0_match_jax_make_train_fn(monkeypatch):
    """Steps at counters 0, 1, 2: the EMA and the actor at 0 and 2 only,
    the decoder at each (the encoder's Adam steps twice a step). Every
    parameter within ``PARAM_TOL``, the losses within ``FWD_TOL`` (0 for a
    skipped actor), each optimizer's step count."""
    g = 3
    cfg = ae_cfg()
    jag, tag, _ = ae_pair(cfg)
    obs, nxt = _raw(BATCH, 3, g), _raw(BATCH, 4, g)
    rng = np.random.default_rng(6)
    batch = {**obs, **{f"next_{k}": v for k, v in nxt.items()}}
    batch["actions"] = rng.uniform(-2, 2, (g, BATCH, ACT)).astype(np.float32)
    batch["rewards"] = rng.standard_normal((g, BATCH, 1)).astype(np.float32)
    batch["terminated"] = (rng.uniform(size=(g, BATCH, 1)) < 0.3).astype(np.float32)
    noise = [[rng.standard_normal((BATCH, ACT)).astype(np.float32) for _ in range(2)] for _ in range(g)]
    key_noise(monkeypatch, list(zip(step_keys(jax.random.PRNGKey(0), g), [n for step in noise for n in step])))
    pnoise = [n for c, step in enumerate(noise) for n in (step if c % 2 == 0 else step[:1])]
    monkeypatch.setattr(tsac_agent, "_normal_noise", lambda gen, like: torch.from_numpy(pnoise.pop(0)).reshape(like.shape))

    def tx(name):
        o = cfg["algo"][name]["optimizer"]
        return joptim.adam(o["lr"], tuple(o["betas"]), o["eps"], float(o.get("weight_decay", 0.0)))

    names = ("actor", "critic", "alpha", "encoder", "decoder")
    state = [jag.encoder_params, jag.decoder_params, jag.actor_params, jag.qfs_params, jag.target_encoder_params, jag.target_qfs_params, jag.log_alpha]
    opts = [tx("actor").init(jag.actor_params), tx("critic").init(jag.qfs_params), tx("alpha").init(jag.log_alpha), tx("encoder").init(jag.encoder_params), tx("decoder").init(jag.decoder_params)]
    fabric = JaxFabric(devices=1, precision="32-true", accelerator="cpu")
    # the JAX loop folds the frame stack on the host (JAX :554-563)
    jbatch = {k: (np.moveaxis(v, 2, 4).reshape(g, BATCH, SCREEN, SCREEN, STACK * 3) if k.endswith("rgb") else v) for k, v in batch.items()}
    train = jsac_ae.make_train_fn(fabric, jag, *(tx(n) for n in names), jdotdict(cfg))
    *out, counter, metrics = train(*state, *opts, jnp.zeros((), jnp.int32), {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0))
    state, opts = out[:7], out[7:12]
    trainer = tsac_ae.SACAETrainer(tag, cfg, torch.device("cpu"), BATCH, _spaces()[1][0], ACT)
    assert trainer.period == 2
    fn = trainer._graph(g, 0)
    for k, v in fn.inputs.items():
        v.copy_(t(batch[k]))
    got = fn()
    close(got, metrics, FWD_TOL, "losses")
    for module, tree in zip((tag.encoder, tag.decoder, tag.actor, tag.qf, tag.target_encoder, tag.target_qf), state[:6]):
        want = from_flax(module, tree)
        for name, p in module.named_parameters():
            close(p, want[name].numpy(), PARAM_TOL, f"{type(module).__name__}.{name}")
    close(tag.log_alpha, state[6], PARAM_TOL, "log_alpha")
    counts = {"actor": 2, "qf": 3, "alpha": 2, "encoder": 6, "decoder": 3}
    assert {k: int(getattr(trainer, f"{k}_opt").count) for k in counts} == counts
    assert [int(o[0].count) for o in opts] == [2, 3, 2, 6, 3]


SAC_AE = [
    "exp=sac_ae",
    "env=pixel_pendulum",
    "env.id=PixelPendulum-v0",
    "fabric=cpu",
    "env.backend=sync",
    "env.capture_video=False",
    "env.num_envs=2",
    "algo.hidden_size=16",
    "algo.cnn_channels_multiplier=1",
    "algo.dense_units=8",
    "algo.encoder.features_dim=8",
    "algo.per_rank_batch_size=4",
    "algo.learning_starts=8",
    "algo.total_steps=16",
    "buffer.size=32",
]


@pytest.mark.parametrize("device", [False, True])
def test_main_trains_on_each_replay(tmp_path, device):
    cfg = dotdict(compose("config", SAC_AE + [f"buffer.device={device}", f"log_base_dir={tmp_path}", "run_name=s"]))
    out = tsac_ae.main(cfg, device="cpu")
    assert cfg.env.screen_size == 64
    assert out["replay_buffer"] == ("device" if device else "memmap")
    assert out["gradient_steps"] == 1 + 2 * 4 and out["test_steps"] > 0
    assert list(out["metrics"])[-1] == "Loss/reconstruction_loss"
    assert all(np.isfinite(v) for v in out["metrics"].values())


def test_cli_dry_run_and_evaluation(tmp_path):
    argv = SAC_AE[:3] + ["fabric=cpu", "dry_run=True", "env.capture_video=False", "algo.cnn_channels_multiplier=1", "algo.hidden_size=16", f"log_base_dir={tmp_path}", "run_name=cli"]
    cli.run(argv)
    (ckpt,) = glob.glob(str(tmp_path / "sac_ae" / "PixelPendulum-v0" / "cli" / "version_0" / "checkpoint" / "*.ckpt"))
    state = load_checkpoint(ckpt)
    assert set(state["agent"]) == {"encoder", "decoder", "actor", "qfs", "target_encoder", "target_qfs", "log_alpha"}
    assert {"encoder_optimizer", "decoder_optimizer", "qf_optimizer", "actor_optimizer", "alpha_optimizer"} <= set(state)
    cli.evaluation([f"checkpoint_path={ckpt}"])
