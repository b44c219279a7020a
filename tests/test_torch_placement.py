"""The placement of the player and of the update (``algo.player_device``,
``algo.train_device``; the JAX ``parallel/fabric.py:547-640`` and
``HostPlayerParams`` :832-940) in the port, on the CPU.

The resolvers are held to the JAX resolvers for every spec: on the CPU
backend as they are, and with the round-trip probe of both packages
patched above and below the 5 ms threshold of a remote card (the JAX
default backend patched to an accelerator). Each family's ``main`` reads
exactly the placement keys its JAX entry point reads. A placed player
acts on a copy of the learner's modules: stale until ``sync_params`` (or
``stream_params`` and ``poll_params``/``flush_params``), then equal to the
learner's player bit for bit. The copy across the bus is card-only and is
held in ``tests/test_torch_cuda.py``.
"""

import types

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.parallel import fabric as jfabric
from sheeprl_tpu_torch.algos.a2c import a2c as ta2c
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as tdv1
from sheeprl_tpu_torch.algos.dreamer_v2 import agent as tdv2_agent
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as tdv2
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tdv3_agent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.droq import droq as tdroq
from sheeprl_tpu_torch.algos.ppo import agent as tppo_agent
from sheeprl_tpu_torch.algos.ppo import ppo as tppo
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as tp2e_dv1
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as tp2e_dv2
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as trppo
from sheeprl_tpu_torch.algos.sac import agent as tsac_agent
from sheeprl_tpu_torch.algos.sac import sac as tsac
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.parallel import fabric as tfabric
from sheeprl_tpu_torch.utils.utils import dotdict
from tests.test_torch_a2c import A2C
from tests.test_torch_cli import TINY as DV3_TINY
from tests.test_torch_dreamer_v1 import CLI as DV1_CLI
from tests.test_torch_dreamer_v1 import TINY as DV1_TINY
from tests.test_torch_dreamer_v2 import CLI as DV2_CLI
from tests.test_torch_dreamer_v2 import dv2_cfg, obs_space
from tests.test_torch_droq import DROQ
from tests.test_torch_p2e_dv2 import CLI as P2E_DV2_CLI
from tests.test_torch_p2e_dv2 import cli_args as p2e_cli_args
from tests.test_torch_ppo import PPO
from tests.test_torch_ppo_recurrent import RPPO
from tests.test_torch_sac import SAC

CPU = torch.device("cpu")
PLAYER_SPECS = [None, "accelerator", "cpu", "auto"]
TRAIN_SPECS = [None, "accelerator", "device", "cpu", "auto"]


# --------------------------------------------------------------------------- #
# the resolvers against the JAX rules
# --------------------------------------------------------------------------- #


def _host(dev):
    return None if dev is None else str(getattr(dev, "platform", getattr(dev, "type", dev)))


@pytest.mark.parametrize("spec", PLAYER_SPECS)
def test_player_device_on_the_cpu_backend_matches_jax(spec):
    """On a run on the CPU every spec is the run's device (None)."""
    assert tfabric.resolve_player_device(spec, CPU) is None
    assert jfabric.resolve_player_device(spec) is None


def _remote_jax(monkeypatch, rtt):
    """The JAX package as on an accelerator whose round trip is ``rtt``."""
    real = jax.local_devices
    accel = types.SimpleNamespace(platform="tpu")
    monkeypatch.setattr(jfabric.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfabric.jax, "local_devices", lambda backend=None: real(backend="cpu") if backend == "cpu" else [accel])
    monkeypatch.setattr(jfabric, "dispatch_roundtrip_seconds", lambda: rtt)


@pytest.mark.parametrize("rtt", [0.0001, 0.05])
def test_auto_resolves_by_the_round_trip_as_jax(rtt, monkeypatch):
    """A card 0.1 ms away keeps the player and the update on it; one 50 ms
    away puts the player, and a model of at most 300,000 params' update, on
    the host. Explicit specs do not probe."""
    _remote_jax(monkeypatch, rtt)
    monkeypatch.setattr(tfabric, "dispatch_roundtrip_seconds", lambda device=None: rtt)
    cuda = torch.device("cuda")
    for spec in PLAYER_SPECS:
        assert _host(tfabric.resolve_player_device(spec, cuda)) == _host(jfabric.resolve_player_device(spec)), spec
    small, big = [torch.zeros(300_000)], [torch.zeros(300_001)]
    for spec in TRAIN_SPECS:
        for params, jparams in ((small, {"w": np.zeros(300_000)}), (big, {"w": np.zeros(300_001)})):
            got = tfabric.resolve_train_device(spec, params, 1, cuda)
            assert _host(got) == _host(jfabric.resolve_train_device(spec, jparams, 1)), (spec, len(params[0]))
    assert tfabric.resolve_train_device("auto", torch.nn.Linear(4, 4), 1, cuda) == (CPU if rtt > 0.005 else None)


def test_train_device_rules_and_errors_match_jax():
    tiny = [torch.zeros(8, 8)]
    for spec in TRAIN_SPECS:
        assert _host(tfabric.resolve_train_device(spec, tiny, 1, CPU)) == _host(jfabric.resolve_train_device(spec, {"w": np.zeros((8, 8))}, 1))
    for fn in (lambda: tfabric.resolve_train_device("cpu", tiny, 2, CPU), lambda: jfabric.resolve_train_device("cpu", {}, 2)):
        with pytest.raises(ValueError, match="single-device"):
            fn()
    assert tfabric.resolve_train_device("auto", tiny, 8, CPU) is None
    for fn in (lambda: tfabric.resolve_train_device("tpu", tiny, 1, CPU), lambda: jfabric.resolve_train_device("tpu", {}, 1)):
        with pytest.raises(ValueError, match="unknown train_device spec"):
            fn()
    for fn in (lambda: tfabric.resolve_player_device("host", CPU), lambda: jfabric.resolve_player_device("host")):
        with pytest.raises(ValueError, match="unknown player device spec"):
            fn()


def test_round_trip_probe_is_cached_and_needs_the_card(monkeypatch):
    monkeypatch.setattr(tfabric, "_rtt_cache", {})
    assert tfabric.dispatch_roundtrip_seconds(CPU) >= 0.0 and set(tfabric._rtt_cache) == {"cpu"}
    first = tfabric._rtt_cache["cpu"]
    assert tfabric.dispatch_roundtrip_seconds(CPU) == first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfabric.dispatch_roundtrip_seconds()


# --------------------------------------------------------------------------- #
# each family reads exactly its JAX keys
# --------------------------------------------------------------------------- #

KEYS = ("overlap_collection", "player_device", "train_device")
READ = set()


class _Reads(dotdict):
    """The ``algo`` node, noting each placement key a ``main`` asks for."""

    def __getitem__(self, key):
        if key in KEYS:
            READ.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in KEYS:
            READ.add(key)
        return super().get(key, default)


SET_ALL = ["+algo.overlap_collection=True", "algo.player_device=cpu", "algo.train_device=cpu"]
FAMILIES = {
    "ppo": (tppo, PPO + ["algo.total_steps=32"], set(KEYS)),
    "a2c": (ta2c, A2C + ["algo.total_steps=16"], {"player_device", "train_device"}),
    "ppo_recurrent": (trppo, RPPO + ["algo.total_steps=16"], {"player_device"}),
    "sac": (tsac, SAC + ["algo.total_steps=12"], {"player_device"}),
    "droq": (tdroq, DROQ + ["algo.total_steps=10"], {"player_device"}),
    "dreamer_v3": (tdv3, DV3_TINY + ["env.backend=sync"], {"player_device"}),
    "dreamer_v2": (tdv2, DV2_CLI, {"player_device"}),
    "dreamer_v1": (tdv1, DV1_CLI, {"player_device"}),
    "p2e_dv2": (tp2e_dv2, ["exp=p2e_dv2_exploration", "dry_run=True", *P2E_DV2_CLI], {"player_device"}),
    "p2e_dv1": (tp2e_dv1, ["exp=p2e_dv1_exploration", "dry_run=True", *p2e_cli_args(DV1_TINY)], {"player_device"}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_family_reads_exactly_its_jax_keys(family, tmp_path):
    """Every placement key set to a value other than its default: a family
    raises on none of them, reads the ones its JAX entry point reads (JAX
    PPO all three, A2C the two placements, every other one
    ``player_device``) and never asks for the others, so they take no
    effect."""
    module, argv, want = FAMILIES[family]
    argv = [a for a in argv if not a.startswith(("algo.player_device", "algo.train_device"))]
    if any(a.startswith("exp=ppo") and "recurrent" not in a for a in argv):
        argv = argv + ["algo.overlap_collection=True", "algo.player_device=cpu", "algo.train_device=cpu"]
    else:
        argv = argv + SET_ALL
    cfg = dotdict(compose("config", argv + [f"log_base_dir={tmp_path}", "run_name=keys", "algo.run_test=False"]))
    cfg["algo"] = _Reads(cfg["algo"])
    READ.clear()
    module.main(cfg, device="cpu")
    assert READ == want


# --------------------------------------------------------------------------- #
# a placed player acts on its own copy
# --------------------------------------------------------------------------- #


def _perturb_(module, scale=0.3, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))


def test_param_mirror_copies_mixed_dtypes_exactly():
    src = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.LayerNorm(5))
    src[0].to(torch.bfloat16)
    src.register_buffer("count", torch.tensor([7], dtype=torch.int64))
    mirror = tfabric.ParamMirror(src, CPU)
    _perturb_(src)
    src.count.add_(1)
    assert not torch.equal(mirror.module[0].weight, src[0].weight)
    mirror.start()
    assert mirror.land(block=True)
    for (n, a), (_, b) in zip(src.state_dict().items(), mirror.module.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    only = tfabric.ParamMirror(src, CPU, prefixes=("1.",))
    _perturb_(src, seed=1)
    only.start()
    only.land(block=True)
    assert torch.equal(only.module[1].weight, src[1].weight) and not torch.equal(only.module[0].weight, src[0].weight)


def _ppo_player():
    cfg = dotdict(compose("config", PPO))
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    return tppo_agent.build_agent((2,), False, cfg, space, device="cpu")


def _sac_player():
    cfg = dotdict(compose("config", SAC))
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    agent, player = tsac_agent.build_agent(cfg, space, spaces.Box(-2, 2, (1,), np.float32), device="cpu")
    return agent.actor, player


def test_placed_players_are_stale_until_synced():
    """PPO's and SAC's placed players act on the params they were given
    until ``sync_params`` (PPO) or ``stream_params`` and a poll (SAC) lands
    the learner's; then their actions equal the learner's player's."""
    rng = np.random.default_rng(0)
    agent, live = _ppo_player()
    placed = tfabric.place_player(tppo_agent.PPOPlayer(agent, CPU), CPU, snapshot=True)
    assert placed.placed and placed.agent is not agent and not live.placed
    obs = {"state": rng.standard_normal((5, 4)).astype(np.float32)}
    _perturb_(agent)

    def act(p):
        return p.get_actions(obs, torch.Generator().manual_seed(3))[0]

    assert not torch.equal(act(placed), act(live))
    placed.sync_params()
    assert torch.equal(act(placed), act(live))

    actor, sac_live = _sac_player()
    sac_placed = tfabric.place_player(tsac_agent.SACPlayer(actor, CPU), CPU, snapshot=True)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    _perturb_(actor, seed=2)
    sac_placed.stream_params()
    sac_placed.flush_params()
    np.testing.assert_array_equal(sac_placed.get_actions(x, greedy=True), sac_live.get_actions(x, greedy=True))


@pytest.mark.parametrize("which", ["dreamer_v3", "dreamer_v2"])
def test_placed_dreamer_player_syncs_only_what_it_reads_and_switches_actors(which):
    """The Dreamer players copy the acting modules of the world model and
    the actor; after a flush they act as the learner's player; a new actor
    assigned to a placed player (P2E's switch) is copied at once."""
    if which == "dreamer_v3":
        from tests.test_torch_dv3_train import obs_space as dv3_space, tiny_cfg

        cfg, space = tiny_cfg(), dv3_space(("rgb",), ("state",))
        wm, actor, live = tdv3_agent.build_agent((3,), False, cfg, space, device="cpu")
        other = tdv3_agent.make_actor(cfg, wm.latent_state_size, (3,), False, torch.float32)
        make = lambda: tdv3_agent.PlayerDV3(wm, actor, (3,), 2, CPU)  # noqa: E731
        screen = 16
    else:
        cfg, space = dv2_cfg(), obs_space()
        wm, actor, _, _, live = tdv2_agent.build_agent((3,), False, cfg, space, device="cpu")
        other = tdv2_agent.ActorDV2(wm.latent_state_size, (3,), False, dense_units=8, mlp_layers=1)
        make = lambda: tdv2_agent.PlayerDV2(wm, actor, (3,), 2, 0, CPU)  # noqa: E731
        screen = 64
    placed = tfabric.place_player(make(), CPU, snapshot=True)
    rng = np.random.default_rng(1)
    obs = {"rgb": rng.integers(0, 256, (2, screen, screen, 3)).astype(np.uint8), "state": rng.standard_normal((2, 5)).astype(np.float32)}
    for m in (wm, actor):
        _perturb_(m, seed=5)
    placed.stream_params()
    placed.flush_params()
    for p in (placed, live):
        p.init_states()
    acts = [p.get_actions(obs, torch.Generator().manual_seed(0), greedy=True) for p in (placed, live)]
    np.testing.assert_array_equal(*acts)
    # only the acting modules are copied: a decoder stays as it was built
    dec = "cnn_decoder"
    assert not torch.equal(getattr(placed.wm, dec).state_dict()[next(iter(getattr(wm, dec).state_dict()))], next(iter(getattr(wm, dec).state_dict().values())))
    placed.actor = other
    assert placed.actor is not other
    for a, b in zip(placed.actor.parameters(), other.parameters()):
        assert torch.equal(a, b)
