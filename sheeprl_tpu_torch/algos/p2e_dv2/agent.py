"""Plan2Explore on Dreamer-V2: the agent (port of
``sheeprl_tpu/algos/p2e_dv2/agent.py``: ``EnsembleDV2`` :32-48,
``init_ensembles`` :55-57 and ``build_agent`` :60-158).

The ensemble's N members are one stacked module
(``algos/p2e_dv3/agent.py::Ensemble`` with ELU members, LayerNorm by
``algo.ensembles.layer_norm``, eps 1e-5): each predicts the next flattened
posterior from ``(z, h, action)``. ``build_agent`` builds Dreamer-V2's world
model, task actor, task critic and its target, then the exploration actor,
the exploration critic and its target, and the ensemble; the player binds
the exploration actor when ``algo.player.actor_type`` is ``exploration``.
Weights are a seeded init; checkpoints load through ``convert``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import ActorDV2, CriticDV2, PlayerDV2, WorldModelDV2, init_weights, make_actor, make_critic
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as dv2_build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble
from sheeprl_tpu_torch.algos.sac.convert import StackedDense, StackedLayerNorm
from sheeprl_tpu_torch.device import DeviceLike, compute_dtype, resolve_device


class P2EDV2Agent(NamedTuple):
    """The models of ``build_agent``, named by their checkpoint keys, and
    the player."""

    world_model: WorldModelDV2
    actor_task: ActorDV2
    critic_task: CriticDV2
    target_critic_task: CriticDV2
    actor_exploration: ActorDV2
    critic_exploration: CriticDV2
    target_critic_exploration: CriticDV2
    ensembles: Ensemble
    player: PlayerDV2


def models_of(agent: NamedTuple) -> Dict[str, nn.Module]:
    """A P2E agent's models by checkpoint key (the player left out)."""
    return {k: v for k, v in agent._asdict().items() if k != "player"}


def build_ensemble(cfg: Mapping[str, Any], in_features: int, output_dim: int, layer_norm: bool) -> Ensemble:
    """``algo.ensembles.n`` ``_MLPBlock`` members (Dense, optional
    LayerNorm with eps 1e-5, ``dense_act``) and an fp32 output Dense, at the
    precision's compute dtype."""
    ens = cfg["algo"]["ensembles"]
    return Ensemble(
        int(ens["n"]),
        in_features,
        output_dim,
        int(ens["mlp_layers"]),
        int(ens["dense_units"]),
        use_layer_norm=layer_norm,
        dtype=compute_dtype(cfg["fabric"]["precision"]),
        eps=1e-5,
        act=str(ens.get("dense_act", "elu")),
    )


@torch.no_grad()
def init_ensemble(ensemble: Ensemble, generator: torch.Generator) -> None:
    """Each member's kernels xavier normal (the JAX ``_dense`` init, the
    output layer's too), zero biases, unit LayerNorm scales."""
    for m in ensemble.modules():
        if isinstance(m, StackedDense):
            fan_in, fan_out = m.kernel.shape[1:]
            m.kernel.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, generator=generator)
            m.bias.zero_()
        elif isinstance(m, StackedLayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()


def exploration_models(cfg: Mapping[str, Any], latent: int, actions_dim: Sequence[int], is_continuous: bool, generator: torch.Generator, layer_norm: Optional[bool] = None):
    """The exploration actor and critic of ``cfg`` (the task ones'
    settings, ``layer_norm`` as ``make_actor``'s), initialised from
    ``generator``."""
    actor = make_actor(cfg, latent, actions_dim, is_continuous, layer_norm)
    critic = make_critic(cfg, latent, layer_norm)
    init_weights(actor, generator)
    init_weights(critic, generator)
    return actor, critic


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg: Mapping[str, Any], obs_space: Any, device: DeviceLike = None) -> P2EDV2Agent:
    """The task models, the exploration models and the player on ``device``
    (the CUDA card unless ``device="cpu"``): the task models as Dreamer-V2
    builds them from ``cfg["seed"]``, the exploration models and the
    ensemble from ``seed + 1``; each target a copy of its critic."""
    dev = resolve_device(device)
    wm, actor_task, critic_task, target_task, player = dv2_build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    latent = wm.latent_state_size
    generator = torch.Generator().manual_seed(int(cfg["seed"]) + 1)
    actor_expl, critic_expl = exploration_models(cfg, latent, actions_dim, is_continuous, generator)
    target_expl = make_critic(cfg, latent)
    target_expl.load_state_dict(critic_expl.state_dict())
    target_expl.requires_grad_(False)
    ensemble = build_ensemble(cfg, latent + int(sum(actions_dim)), wm.stoch_state_size, bool(cfg["algo"]["ensembles"].get("layer_norm", False)))
    init_ensemble(ensemble, generator)
    for m in (actor_expl, critic_expl, target_expl, ensemble):
        m.to(dev)
    # the player explores with the exploration actor (JAX :152-153)
    if str(cfg["algo"]["player"].get("actor_type", "task")) == "exploration":
        player.actor = actor_expl
    return P2EDV2Agent(wm, actor_task, critic_task, target_task, actor_expl, critic_expl, target_expl, ensemble, player)
