"""Plan2Explore on Dreamer-V3: the agent (port of
``sheeprl_tpu/algos/p2e_dv3/agent.py``: ``Ensemble`` :42-57,
``ensemble_apply`` :60-62 and ``build_agent`` :73-188).

The ensemble's N members are one stacked module: each layer holds the N
members' kernels ``[N, in, out]`` (``algos/sac/convert.py::StackedDense``,
the layout of the JAX package's vmapped param tree) and runs one batched
product for all members, where the JAX package vmaps one member's apply.
A member is an ``_LNMLP`` (Dense, LayerNorm with eps 1e-3, SiLU) in the
precision's compute dtype and an fp32 output Dense to the flattened
stochastic state.

``build_agent`` builds Dreamer-V3's world model, task actor, task critic and
its target, then the exploration actor, one critic (with its target) for
each exploration critic of positive weight, and the ensemble. The player
binds the exploration actor when ``algo.player.actor_type`` is
``exploration``. Weights are a seeded init; checkpoints load through
``convert.load_checkpoint_state``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Critic,
    PlayerDV3,
    WorldModel,
    init_weights,
    make_actor,
    make_critic,
    variance_scaling_,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as dv3_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_critic
from sheeprl_tpu_torch.algos.sac.convert import StackedDense, StackedLayerNorm
from sheeprl_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from sheeprl_tpu_torch.models.blocks import get_activation

# {name: {"weight": float, "reward_type": "intrinsic" | "task", "critic": Critic, "target": Critic}}
ExplorationCritics = Dict[str, Dict[str, Any]]


class P2EAgent(NamedTuple):
    """The models of ``build_agent``, named by their checkpoint keys, and
    the player."""

    world_model: WorldModel
    actor_task: Actor
    critic_task: Critic
    target_critic_task: Critic
    actor_exploration: Actor
    critics_exploration: ExplorationCritics
    ensembles: "Ensemble"
    player: PlayerDV3


class Ensemble(nn.Module):
    """``n`` members from ``[..., in]`` to ``[n, ..., output_dim]``, each
    ``mlp_layers`` x (Dense of ``dense_units`` (+ LayerNorm) + ``act``)
    computing in ``dtype`` (LayerNorm statistics in fp32, cast back) and an
    fp32 output Dense, all members in one batched product per layer:
    Dreamer-V3's ``_LNMLP`` members (SiLU, LayerNorm with eps 1e-3) by
    default, Dreamer-V1's and V2's ELU ``_MLPBlock`` members with ``act``
    and ``use_layer_norm``."""

    def __init__(
        self,
        n: int,
        in_features: int,
        output_dim: int,
        mlp_layers: int,
        dense_units: int,
        use_layer_norm: bool = True,
        dtype: torch.dtype = torch.float32,
        eps: float = 1e-3,
        act: str = "silu",
    ) -> None:
        super().__init__()
        self.n, self.dtype, self.act = int(n), dtype, get_activation(act)
        dims = [in_features] + [dense_units] * mlp_layers
        self.linears = nn.ModuleList(StackedDense(n, a, b, compute_dtype=dtype) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(StackedLayerNorm(n, dense_units, eps=eps) for _ in range(mlp_layers if use_layer_norm else 0))
        self.head = StackedDense(n, dense_units, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(-1, x.shape[-1]).to(self.dtype)
        for i, linear in enumerate(self.linears):
            h = linear(h)
            if len(self.norms):
                h = self.norms[i](h).to(self.dtype)
            h = self.act(h)
        return self.head(h).reshape(self.n, *lead, -1)


@torch.no_grad()
def init_ensemble(ensemble: Ensemble, generator: torch.Generator) -> None:
    """Each member's kernels by Hafner's truncated normal (the JAX
    ``hafner_init``, output layer included), zero biases, unit LayerNorm
    scales."""
    for m in ensemble.modules():
        if isinstance(m, StackedDense):
            for k in m.kernel:
                variance_scaling_(k, 1.0, "fan_avg", "truncated_normal", generator, in_out=True)
            m.bias.zero_()
        elif isinstance(m, StackedLayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()


def build_ensemble(cfg: Dict[str, Any], wm: WorldModel, actions_dim: Sequence[int], dtype: torch.dtype) -> Ensemble:
    """The ensemble of ``cfg["algo"]["ensembles"]``: it reads ``(z, h,
    action)`` and predicts the next flattened stochastic state."""
    ens = cfg["algo"]["ensembles"]
    return Ensemble(
        int(ens["n"]),
        wm.latent_state_size + int(sum(actions_dim)),
        wm.stoch_state_size,
        int(ens["mlp_layers"]),
        int(ens["dense_units"]),
        use_layer_norm=bool(ens.get("layer_norm", True)),
        dtype=dtype,
    )


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: Any,
    device: DeviceLike = None,
) -> P2EAgent:
    """The task models, the exploration models and the player on ``device``
    (the CUDA card unless ``device="cpu"``), seeded from ``cfg["seed"]``:
    the task models as Dreamer-V3 builds them, the exploration models from
    ``seed + 2``. An exploration critic of weight <= 0 is left out; without
    an intrinsic one the build raises."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg["fabric"]["precision"])
    algo = cfg["algo"]
    wm, actor_task, player = dv3_build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    latent = wm.latent_state_size
    critic_task, target_critic_task = build_critic(cfg, latent, device=dev)
    generator = torch.Generator().manual_seed(int(cfg["seed"]) + 2)

    actor_exploration = make_actor(cfg, latent, actions_dim, is_continuous, dtype)
    init_weights(actor_exploration, generator)
    actor_exploration.to(dev).eval()

    critics: ExplorationCritics = {}
    for k, v in algo["critics_exploration"].items():
        if float(v["weight"]) <= 0:
            continue
        critic, target = make_critic(algo["critic"], latent, dtype), make_critic(algo["critic"], latent, dtype)
        init_weights(critic, generator)
        target.load_state_dict(critic.state_dict())
        target.requires_grad_(False)
        critics[k] = {"weight": float(v["weight"]), "reward_type": str(v["reward_type"]), "critic": critic.to(dev), "target": target.to(dev)}
    if not any(c["reward_type"] == "intrinsic" for c in critics.values()):
        raise RuntimeError("You must specify at least one intrinsic critic (`reward_type='intrinsic'`)")

    ensemble = build_ensemble(cfg, wm, actions_dim, dtype)
    init_ensemble(ensemble, generator)
    ensemble.to(dev)

    # the player explores with the exploration actor (JAX :171-173)
    if str(algo["player"].get("actor_type", "task")) == "exploration":
        player.actor = actor_exploration
    return P2EAgent(wm, actor_task, critic_task, target_critic_task, actor_exploration, critics, ensemble, player)
