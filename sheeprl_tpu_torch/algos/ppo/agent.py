"""PPO agent (port of ``sheeprl_tpu/algos/ppo/agent.py:28-297``).

One ``PPOAgent`` module: a shared encoder (``NatureCNN`` over the pixel
keys, concatenated on channels, and an ``MLP`` over the vector keys), an
actor backbone with one head per action space, and a critic. ``forward``
returns the raw heads and the fp32 values; the sampling and log-prob math
lives in :func:`sample_actions` and :func:`evaluate_actions`, so the same
module serves the update and the player.

Observations come as the env gives them: pixels NHWC ``uint8`` (scaled to
``[-0.5, 0.5]`` inside the module, in the compute dtype, as the JAX
``CNNEncoder`` does) and vectors float. Precision: the layers compute in
``fabric.precision``'s compute dtype; the heads' outputs and the values are
cast to fp32 before the distributions. :func:`build_agent` casts the
parameters to the precision's ``param_dtype`` after init or load (JAX
``:296``), so ``bf16-true`` holds bf16 parameters.

A sampler draws from an explicit ``torch.Generator`` (the JAX package
takes a key): a categorical head is one Gumbel-max ``torch.rand``, a
continuous head one ``torch.randn``, so a CUDA graph captures both.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import variance_scaling_
from sheeprl_tpu_torch.device import DeviceLike, Precision, resolve_device
from sheeprl_tpu_torch.models.blocks import MLP, Dense, NatureCNN
from sheeprl_tpu_torch.ops.distributions import Categorical, Independent, Normal
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.parallel.fabric import HostPlayerParams


def _image_channels(shape: Sequence[int]) -> int:
    """Channels a pixel key brings: ``[H, W, C]``, or ``[S, H, W, C]`` with
    the frame stack folded into channels."""
    return int(shape[0] * shape[-1]) if len(shape) == 4 else int(shape[-1])


class CNNEncoder(nn.Module):
    """Pixel keys concatenated on channels, scaled to ``[-0.5, 0.5]``, then
    ``NatureCNN`` (JAX ``:28-39``)."""

    def __init__(self, keys: Sequence[str], in_channels: int, image_size: int, features_dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.dtype = dtype
        self.cnn = NatureCNN(in_channels, image_size, features_dim, compute_dtype=dtype)
        self.output_dim = self.cnn.output_dim

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k].to(self.dtype) / 255.0 - 0.5 for k in self.keys], -1)
        return self.cnn(x.permute(0, 3, 1, 2))


class MLPEncoder(nn.Module):
    """Vector keys concatenated, then an ``MLP`` (JAX ``:42-62``)."""

    def __init__(
        self,
        keys: Sequence[str],
        in_features: int,
        features_dim: Optional[int],
        units: int,
        layers: int,
        act: str,
        layer_norm: bool,
        dtype: torch.dtype,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.dtype = dtype
        self.mlp = MLP(in_features, (units,) * layers, features_dim, act, layer_norm, compute_dtype=dtype)
        self.output_dim = self.mlp.output_dim

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k].to(self.dtype) for k in self.keys], -1))


class PPOAgent(nn.Module):
    """Encoder, critic and actor (JAX ``:65-128``): ``forward(obs) ->
    (heads, values [B, 1] fp32)``. A continuous actor has one head of
    ``2 * sum(actions_dim)`` (mean ++ log_std); a discrete one a head of
    logits per action space."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_channels: int = 0,
        image_size: int = 64,
        mlp_in_features: int = 0,
        cnn_features_dim: int = 512,
        mlp_features_dim: Optional[int] = 64,
        encoder_units: int = 64,
        encoder_layers: int = 2,
        actor_units: int = 64,
        actor_layers: int = 2,
        critic_units: int = 64,
        critic_layers: int = 2,
        dense_act: str = "tanh",
        layer_norm: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.dtype = dtype
        feat = 0
        self.cnn_encoder = self.mlp_encoder = None
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoder(self.cnn_keys, cnn_channels, image_size, cnn_features_dim, dtype)
            feat += self.cnn_encoder.output_dim
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoder(
                self.mlp_keys, mlp_in_features, mlp_features_dim, encoder_units, encoder_layers, dense_act, layer_norm, dtype
            )
            feat += self.mlp_encoder.output_dim
        self.critic = MLP(feat, (critic_units,) * critic_layers, 1, dense_act, layer_norm, compute_dtype=dtype)
        self.actor_backbone = MLP(feat, (actor_units,) * actor_layers, None, dense_act, layer_norm, compute_dtype=dtype)
        back = self.actor_backbone.output_dim
        if self.is_continuous:
            heads = [Dense(back, sum(self.actions_dim) * 2, compute_dtype=dtype)]
        else:
            heads = [Dense(back, d, compute_dtype=dtype) for d in self.actions_dim]
        self.actor_heads = nn.ModuleList(heads)

    def forward(self, obs: Mapping[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        feat = feats[0] if len(feats) == 1 else torch.cat(feats, -1)
        values = self.critic(feat).float()
        x = self.actor_backbone(feat)
        return [head(x) for head in self.actor_heads], values


def _dists(agent: Any, actor_out: List[torch.Tensor]) -> List[Any]:
    if agent.is_continuous:
        mean, log_std = actor_out[0].float().chunk(2, -1)
        return [Independent(Normal(mean, log_std.exp()), 1)]
    return [Categorical(logits=h.float()) for h in actor_out]


def sample_heads(
    agent: Any, actor_out: List[torch.Tensor], generator: Optional[torch.Generator] = None, greedy: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(actions, logprobs [..., 1])`` drawn from the actor's raw heads:
    the concatenated one-hots (discrete) or the raw vector (continuous),
    the layout the rollout stores; a multi-discrete space draws its heads
    in order and sums their log-probs."""
    dists = _dists(agent, actor_out)
    if agent.is_continuous:
        d = dists[0]
        act = d.mode if greedy else d.sample(generator)
        return act, d.log_prob(act)[..., None]
    samples = [d.mode if greedy else d.sample(generator) for d in dists]
    logprob = sum(d.log_prob(s) for d, s in zip(dists, samples))[..., None]
    onehots = [nn.functional.one_hot(s, dim).float() for s, dim in zip(samples, agent.actions_dim)]
    return torch.cat(onehots, -1), logprob


def evaluate_heads(agent: Any, actor_out: List[torch.Tensor], actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logprobs [..., 1], entropy [..., 1])`` of stored ``actions`` under
    the actor's raw heads; the heads of a multi-discrete space are
    summed."""
    dists = _dists(agent, actor_out)
    if agent.is_continuous:
        d = dists[0]
        return d.log_prob(actions)[..., None], d.entropy()[..., None]
    parts = torch.split(actions, list(agent.actions_dim), -1)
    logprob = sum(d.log_prob(p.argmax(-1)) for d, p in zip(dists, parts))[..., None]
    entropy = sum(d.entropy() for d in dists)[..., None]
    return logprob, entropy


def sample_actions(
    agent: PPOAgent, obs: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None, greedy: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rollout policy (JAX ``:137-164``): ``(actions, logprobs [B, 1],
    values [B, 1])`` (:func:`sample_heads`)."""
    actor_out, values = agent(obs)
    return (*sample_heads(agent, actor_out, generator, greedy), values)


def evaluate_actions(
    agent: PPOAgent, obs: Mapping[str, torch.Tensor], actions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stored actions re-evaluated for the update (JAX ``:167-189``):
    ``(logprobs [B, 1], entropy [B, 1], values [B, 1])``."""
    actor_out, values = agent(obs)
    return (*evaluate_heads(agent, actor_out, actions), values)


def real_actions_from_onehot(actions_dim: Sequence[int], is_continuous: bool, actions: torch.Tensor) -> torch.Tensor:
    """Concatenated one-hots -> the env's index per action space (``[B,
    n_spaces]``); continuous actions as they are."""
    if is_continuous:
        return actions
    return torch.stack([p.argmax(-1) for p in torch.split(actions, list(actions_dim), -1)], -1)


def rollout_step(
    agent: PPOAgent, obs: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rollout-time policy call: ``(actions, real_actions, logprobs,
    values)``."""
    actions, logprob, values = sample_actions(agent, obs, generator)
    return actions, real_actions_from_onehot(agent.actions_dim, agent.is_continuous, actions), logprob, values


class PPOPlayer(HostPlayerParams):
    """The agent on its device for rollouts and evaluation: observations in
    as numpy (pixels stay ``uint8`` across the bus), tensors out. On the
    card ``rollout_actions`` replays one CUDA graph of :func:`rollout_step`
    (captured at the first call, the generator registered with it) over
    static observation tensors, as the JAX player jits it into one
    program; elsewhere it runs eagerly. Placed (``place_player``), it acts
    on its own copy of the agent."""

    _placed_attrs = ("agent",)

    def __init__(self, agent: PPOAgent, device: torch.device) -> None:
        self.agent = agent
        self.device = device
        self._rollout: Optional[CapturedStep] = None

    def to_device(self, obs: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        keys = self.agent.cnn_keys + self.agent.mlp_keys
        return {k: torch.as_tensor(obs[k]).to(self.device, non_blocking=True) for k in keys}

    @torch.no_grad()
    def get_actions(
        self, obs: Mapping[str, np.ndarray], generator: Optional[torch.Generator] = None, greedy: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return sample_actions(self.agent, self.to_device(obs), generator, greedy)

    @torch.no_grad()
    def rollout_actions(
        self, obs: Mapping[str, np.ndarray], generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.device.type != "cuda":
            return rollout_step(self.agent, self.to_device(obs), generator)
        if self._rollout is None or self._rollout.generators != (generator,):
            inputs = {k: v.clone() for k, v in self.to_device(obs).items()}
            agent = self.agent
            self._rollout = CapturedStep(lambda d: rollout_step(agent, d, generator), inputs, (), generator)
        for k, v in self._rollout.inputs.items():
            v.copy_(torch.as_tensor(obs[k]), non_blocking=True)
        return self._rollout()

    @torch.no_grad()
    def get_values(self, obs: Mapping[str, np.ndarray]) -> torch.Tensor:
        return self.agent(self.to_device(obs))[1]


def init_weights(agent: PPOAgent, generator: torch.Generator) -> None:
    """flax's defaults from an explicit generator: lecun normal kernels
    (variance scaling 1, fan in, truncated normal), zero biases, unit
    LayerNorm scales."""
    for m in agent.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            variance_scaling_(m.weight, 1.0, "fan_in", "truncated_normal", generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Mapping[str, Any],
    obs_space: Any,
    agent_state: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[PPOAgent, PPOPlayer]:
    """The agent on ``device`` (the CUDA card unless ``device="cpu"``) and
    its player (JAX ``:257-297``): weights from ``agent_state`` (a state
    dict, see ``convert``) or a seeded init from ``cfg["seed"]``, then cast
    to ``fabric.precision``'s ``param_dtype``."""
    dev = resolve_device(device)
    precision = Precision(str(cfg["fabric"]["precision"]))
    algo = cfg["algo"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    image_size = int(obs_space[cnn_keys[0]].shape[-2]) if cnn_keys else 64
    agent = PPOAgent(
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_channels=sum(_image_channels(obs_space[k].shape) for k in cnn_keys),
        image_size=image_size,
        mlp_in_features=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
        cnn_features_dim=int(algo["encoder"].get("cnn_features_dim", 512)),
        mlp_features_dim=algo["encoder"]["mlp_features_dim"],
        encoder_units=int(algo["encoder"]["dense_units"]),
        encoder_layers=int(algo["encoder"]["mlp_layers"]),
        actor_units=int(algo["actor"]["dense_units"]),
        actor_layers=int(algo["actor"]["mlp_layers"]),
        critic_units=int(algo["critic"]["dense_units"]),
        critic_layers=int(algo["critic"]["mlp_layers"]),
        dense_act=str(algo["dense_act"]),
        layer_norm=bool(algo["layer_norm"]),
        dtype=precision.compute_dtype,
    )
    if agent_state is None:
        init_weights(agent, torch.Generator().manual_seed(int(cfg["seed"])))
    else:
        agent.load_state_dict({k: torch.as_tensor(v) for k, v in agent_state.items()})
    agent.to(device=dev, dtype=precision.param_dtype)
    return agent, PPOPlayer(agent, dev)
