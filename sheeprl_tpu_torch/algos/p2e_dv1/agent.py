"""Plan2Explore on Dreamer-V1: the agent (port of
``sheeprl_tpu/algos/p2e_dv1/agent.py``: ``EnsembleDV1`` :33-46,
``embedding_dim`` :59-68 and ``build_agent`` :71-143).

The ensemble (P2E-DV2's stacked ELU members, no LayerNorm) predicts the
next **embedded observation** from ``(z, h, action)``: Dreamer-V1 measures
disagreement in embedding space, where V2 and V3 measure it in posterior
space. ``build_agent`` builds Dreamer-V1's world model, task actor and task
critic, then the exploration actor and critic (no target critics in
Dreamer-V1) and the ensemble; the player binds the exploration actor when
``algo.player.actor_type`` is ``exploration``.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import ActorDV1, CriticDV1, PlayerDV1, WorldModelDV1
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_ensemble, exploration_models, init_ensemble
from sheeprl_tpu_torch.algos.p2e_dv3.agent import Ensemble
from sheeprl_tpu_torch.device import DeviceLike, resolve_device


class P2EDV1Agent(NamedTuple):
    """The models of ``build_agent``, named by their checkpoint keys, and
    the player."""

    world_model: WorldModelDV1
    actor_task: ActorDV1
    critic_task: CriticDV1
    actor_exploration: ActorDV1
    critic_exploration: CriticDV1
    ensembles: Ensemble
    player: PlayerDV1


def build_agent(actions_dim: Sequence[int], is_continuous: bool, cfg: Mapping[str, Any], obs_space: Any, device: DeviceLike = None) -> P2EDV1Agent:
    """The task models, the exploration models and the player on ``device``
    (the CUDA card unless ``device="cpu"``): the task models as Dreamer-V1
    builds them from ``cfg["seed"]``, the exploration models and the
    ensemble from ``seed + 1``."""
    dev = resolve_device(device)
    wm, actor_task, critic_task, player = dv1_build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    latent = wm.latent_state_size
    generator = torch.Generator().manual_seed(int(cfg["seed"]) + 1)
    actor_expl, critic_expl = exploration_models(cfg, latent, actions_dim, is_continuous, generator, layer_norm=False)
    ensemble = build_ensemble(cfg, latent + int(sum(actions_dim)), wm.embedding_dim, layer_norm=False)
    init_ensemble(ensemble, generator)
    for m in (actor_expl, critic_expl, ensemble):
        m.to(dev)
    # the player explores with the exploration actor (JAX :137-138)
    if str(cfg["algo"]["player"].get("actor_type", "task")) == "exploration":
        player.actor = actor_expl
    return P2EDV1Agent(wm, actor_task, critic_task, actor_expl, critic_expl, ensemble, player)
