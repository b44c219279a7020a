"""SAC agent (port of ``sheeprl_tpu/algos/sac/agent.py``): the critic
ensemble, the tanh-squashed Gaussian actor, its action sampling and the
agent and player handles.

The critic ensemble is one module with stacked parameters, as the JAX
package vmaps one flax critic over stacked params (:28-47, :138-142): every
layer of every member runs as one batched product
(``convert.StackedDense``), and ``forward`` returns ``[B, n]``. DroQ's
critic is the same module with dropout after each hidden product and an
fp32 LayerNorm after that (:38-46); its masks come from a generator, as
flax draws them from a ``dropout`` rng.

Precision is flax's: hidden products in the compute dtype with fp32
parameters, the Q head and the mean and log-std heads in fp32.

The actor's log-prob is the JAX expression (:78-92), the Normal density of
the pre-squash sample minus ``log(scale * (1 - tanh^2) + 1e-6)``, summed
over the action; torch's ``TanhTransform`` and ``Normal.log_prob`` differ
from it in the epsilon. The noise of a sample comes from a generator
(``_normal_noise``), so a CUDA graph that registers it draws fresh noise at
every replay.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.sac.convert import LOG_ALPHA, StackedDense, StackedLayerNorm, flax_init_, load_, to_flax
from sheeprl_tpu_torch.device import DeviceLike, Precision, resolve_device
from sheeprl_tpu_torch.envs.spaces import Box
from sheeprl_tpu_torch.models.blocks import Dense

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0
_LOG_2PI = math.log(2 * math.pi)


def _normal_noise(generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise shaped as ``like``, in fp32, from ``generator``."""
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=torch.float32)


def _uniform(generator: Optional[torch.Generator], shape: Sequence[int], device: torch.device) -> torch.Tensor:
    """``U[0, 1)`` draws of ``shape`` from ``generator`` (dropout masks)."""
    return torch.rand(tuple(shape), generator=generator, device=device)


class SACCritic(nn.Module):
    """``n`` Q(s, a) MLPs of two hidden layers, stacked: ``Dense_0`` and
    ``Dense_1`` (``hidden_size``, ReLU), ``Dense_2`` (one Q value, fp32).
    With ``dropout`` > 0 (DroQ) each hidden product is followed by dropout
    when a generator is passed (flax's ``deterministic=False``); with
    ``layer_norm`` by an fp32 LayerNorm cast back to the compute dtype."""

    def __init__(
        self,
        in_features: int,
        hidden_size: int = 256,
        num_critics: int = 2,
        dropout: float = 0.0,
        layer_norm: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_critics = int(num_critics)
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype
        n = self.num_critics
        self.Dense_0 = StackedDense(n, in_features, hidden_size, compute_dtype)
        self.Dense_1 = StackedDense(n, hidden_size, hidden_size, compute_dtype)
        self.Dense_2 = StackedDense(n, hidden_size, 1, torch.float32)
        if layer_norm:
            self.LayerNorm_0 = StackedLayerNorm(n, hidden_size)
            self.LayerNorm_1 = StackedLayerNorm(n, hidden_size)
        self.layer_norm = bool(layer_norm)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, n]`` Q values; dropout is on when ``generator`` is given."""
        x = torch.cat([obs, action], -1).to(self.compute_dtype)
        for i in range(2):
            x = getattr(self, f"Dense_{i}")(x)
            if self.dropout > 0.0 and generator is not None:
                keep = 1.0 - self.dropout
                mask = _uniform(generator, x.shape, x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x).to(self.compute_dtype)
            x = torch.relu(x)
        return self.Dense_2(x)[..., 0].t()


class SACActor(nn.Module):
    """The tanh-squashed Gaussian policy (JAX :50-75): ``Dense_0`` and
    ``Dense_1`` (``hidden_size``, ReLU), then the fp32 ``fc_mean`` and
    ``fc_logstd`` heads. SAC clips the raw log-std to
    ``[log_std_min, log_std_max]`` when it samples; with ``tanh_log_std``
    (SAC-AE's actor, ``sac_ae/agent.py:212-223``) the module itself maps it
    through ``tanh`` onto that range. ``action_scale`` and ``action_bias``
    rescale the squashed action onto the bounds."""

    def __init__(
        self,
        in_features: int,
        action_dim: int,
        hidden_size: int = 256,
        action_low: Sequence[float] = (-1.0,),
        action_high: Sequence[float] = (1.0,),
        compute_dtype: torch.dtype = torch.float32,
        tanh_log_std: bool = False,
        log_std_min: float = LOG_STD_MIN,
        log_std_max: float = LOG_STD_MAX,
    ) -> None:
        super().__init__()
        self.tanh_log_std = bool(tanh_log_std)
        self.log_std_min, self.log_std_max = float(log_std_min), float(log_std_max)
        self.Dense_0 = Dense(in_features, hidden_size, compute_dtype=compute_dtype)
        self.Dense_1 = Dense(hidden_size, hidden_size, compute_dtype=compute_dtype)
        self.fc_mean = Dense(hidden_size, action_dim)
        self.fc_logstd = Dense(hidden_size, action_dim)
        flax_init_(self)
        low = torch.tensor(action_low, dtype=torch.float32)
        high = torch.tensor(action_high, dtype=torch.float32)
        self.register_buffer("action_scale", (high - low) / 2.0)
        self.register_buffer("action_bias", (high + low) / 2.0)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        mean, log_std = self.fc_mean(x), self.fc_logstd(x)
        if self.tanh_log_std:
            log_std = self.log_std_min + 0.5 * (self.log_std_max - self.log_std_min) * (torch.tanh(log_std) + 1)
        return mean, log_std


def actor_action_and_log_prob(
    actor: SACActor, obs: torch.Tensor, generator: Optional[torch.Generator]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reparameterised squashed action and its log-prob ``[B, 1]`` (JAX
    :78-92, Eq. 26 of the SAC paper)."""
    mean, log_std = actor(obs)
    if not actor.tanh_log_std:
        log_std = log_std.clamp(actor.log_std_min, actor.log_std_max)
    std = torch.exp(log_std)
    x_t = mean + std * _normal_noise(generator, mean)
    y_t = torch.tanh(x_t)
    action = y_t * actor.action_scale + actor.action_bias
    log_prob = -0.5 * (torch.square((x_t - mean) / std) + 2 * torch.log(std) + _LOG_2PI)
    log_prob = log_prob - torch.log(actor.action_scale * (1 - torch.square(y_t)) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


def actor_greedy_action(actor: SACActor, obs: torch.Tensor) -> torch.Tensor:
    mean, _ = actor(obs)
    return torch.tanh(mean) * actor.action_scale + actor.action_bias


class SACAgent(nn.Module):
    """The actor, the critic ensemble, its target copy and ``log_alpha``
    (JAX ``SACAgent`` :95-126). The target's parameters take no gradient
    and move only by the EMA."""

    def __init__(
        self, actor: SACActor, critic: SACCritic, target_entropy: float, alpha: float = 1.0, tau: float = 0.005
    ) -> None:
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = _frozen_copy(critic)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
        self.target_entropy = float(target_entropy)
        self.tau = float(tau)
        self.num_critics = critic.num_critics

    def flax_state(self) -> Dict[str, Any]:
        """``agent`` in the JAX checkpoint layout (JAX ``sac.py:414-419``)."""
        return {
            "actor": to_flax(self.actor, dict(self.actor.named_parameters())),
            "critics": to_flax(self.critic, dict(self.critic.named_parameters())),
            "target_critics": to_flax(self.target_critic, dict(self.target_critic.named_parameters())),
            "log_alpha": LOG_ALPHA[1]({"log_alpha": self.log_alpha}),
        }

    @torch.no_grad()
    def load_flax_state(self, state: Mapping[str, Any]) -> None:
        """Copy a JAX-layout ``agent`` into the parameters, in place."""
        load_(self.actor, state["actor"])
        load_(self.critic, state["critics"])
        load_(self.target_critic, state["target_critics"])
        self.log_alpha.copy_(LOG_ALPHA[0](state["log_alpha"])["log_alpha"])


def _frozen_copy(module: nn.Module) -> nn.Module:
    import copy

    target = copy.deepcopy(module)
    for p in target.parameters():
        p.requires_grad_(False)
    return target


class SACPlayer:
    """The acting policy over the agent's own actor (JAX ``SACPlayer``
    :145-173): on one device the player reads the live parameters, so
    there is nothing to stream."""

    def __init__(self, actor: SACActor, device: torch.device) -> None:
        self.actor = actor
        self.device = device

    @torch.no_grad()
    def get_actions(self, obs: np.ndarray, generator: Optional[torch.Generator] = None, greedy: bool = False) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        if greedy:
            return actor_greedy_action(self.actor, x).cpu().numpy()
        return actor_action_and_log_prob(self.actor, x, generator)[0].cpu().numpy()


def finite_action_bounds(action_space: Box) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Per-dimension ``(low, high)`` with non-finite bounds clamped to
    +-1 (JAX :176-187): an unbounded Box means no rescale."""
    low = np.asarray(action_space.low, np.float32).ravel()
    high = np.asarray(action_space.high, np.float32).ravel()
    unbounded = ~(np.isfinite(low) & np.isfinite(high))
    low = np.where(unbounded, -1.0, low).astype(np.float32)
    high = np.where(unbounded, 1.0, high).astype(np.float32)
    return tuple(low.tolist()), tuple(high.tolist())


def compute_dtype_of(cfg: Mapping[str, Any]) -> torch.dtype:
    return Precision(str(cfg["fabric"]["precision"])).compute_dtype


def build_agent(
    cfg: Mapping[str, Any],
    obs_space: Any,
    action_space: Box,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
    critic_kwargs: Optional[Mapping[str, Any]] = None,
) -> Tuple[SACAgent, SACPlayer]:
    """The agent and its player on ``device`` (the card by default; JAX
    :190-247): an actor and ``algo.critic.n`` critics over the concatenated
    ``algo.mlp_keys.encoder``, ``log_alpha = log(algo.alpha.alpha)``, a
    seeded init, or ``agent_state`` (the JAX checkpoint layout)."""
    dev = resolve_device(device)
    algo = cfg["algo"]
    act_dim = int(np.prod(action_space.shape))
    obs_dim = int(sum(np.prod(obs_space[k].shape) for k in algo["mlp_keys"]["encoder"]))
    dtype = compute_dtype_of(cfg)
    low, high = finite_action_bounds(action_space)
    # a seeded init that leaves the global generator as it was
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg["seed"]))
        actor = SACActor(obs_dim, act_dim, int(algo["actor"]["hidden_size"]), low, high, dtype)
        critic = SACCritic(
            obs_dim + act_dim, int(algo["critic"]["hidden_size"]), int(algo["critic"]["n"]), compute_dtype=dtype, **(critic_kwargs or {})
        )
    agent = SACAgent(actor, critic, target_entropy=-act_dim, alpha=float(algo["alpha"]["alpha"]), tau=float(algo["tau"]))
    if agent_state is not None:
        agent.load_flax_state(agent_state)
    agent.to(dev)
    return agent, SACPlayer(agent.actor, dev)
