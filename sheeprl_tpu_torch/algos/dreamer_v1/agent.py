"""Dreamer-V1 agent (port of ``sheeprl_tpu/algos/dreamer_v1/agent.py``:
``RecurrentModelDV1`` :67-83, ``WorldModelDV1`` :86-247, ``rssm_scan_dv1``
:250-274 and ``build_agent`` :277-410).

Dreamer-V1 is Dreamer-V2's layout (the port's ``algos/dreamer_v2/agent.py``
encoders, decoders, actor, critic and player, as the JAX package reuses
them) with three differences: the stochastic state is a diagonal Gaussian
(the representation and transition heads emit ``2 * stochastic_size``
values, ``std = softplus(std) + min_std``), the recurrent model is one
Dense and act into a plain GRU cell (``models/blocks.py::GRUCell``, flax's
``nn.GRUCell``), and the RSSM has no ``is_first`` gating. LayerNorm is off
everywhere and there is no target critic. The GRU reaches no TPU kernel,
so no CUDA kernel either.

Submodules take the names of their flax scopes (``_MLPBlock_0``,
``GRUCell_0/{ir, iz, in, hr, hz, hn}``, ``layers_0``, ...), so
``algos/dreamer_v2/convert.py`` maps every leaf. Precision follows
``device.Precision`` as Dreamer-V2's does: the trunks and the GRU compute
in the compute dtype, the representation, transition, reward and continue
heads in fp32, and the new recurrent state is fp32.

The Gaussian draw is :func:`gaussian_noise`, one standard normal a call
from the caller's generator; the tests swap it to inject the JAX package's
draws.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    ActorDV2,
    CNNDecoderDV2,
    CNNEncoderDV2,
    CriticDV2,
    MLPDecoderDV2,
    MLPEncoderDV2,
    PlayerDV2,
    _Head,
    _image_channels,
    _MLPBlock,
    actor_dists,
    actor_logprob_entropy,
    add_exploration_noise,
    conv_output_side,
    init_weights as dv2_init_weights,
    make_actor,
    make_critic,
    sample_actor_actions,
)
from sheeprl_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from sheeprl_tpu_torch.models.blocks import Dense, GRUCell

# Dreamer-V1 reuses Dreamer-V2's actor, critic and player (JAX :45-50)
ActorDV1 = ActorDV2
CriticDV1 = CriticDV2
PlayerDV1 = PlayerDV2

__all__ = [
    "ActorDV1",
    "CriticDV1",
    "PlayerDV1",
    "RecurrentModelDV1",
    "WorldModelDV1",
    "actor_dists",
    "actor_logprob_entropy",
    "add_exploration_noise",
    "build_agent",
    "rssm_scan_dv1",
    "sample_actor_actions",
]


def gaussian_noise(like: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A standard normal draw of ``like``'s shape, dtype and device."""
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


class RecurrentModelDV1(nn.Module):
    """``_MLPBlock_0`` (one Dense of ``recurrent_state_size`` units + act)
    into ``GRUCell_0``; the new state in fp32."""

    def __init__(self, input_size: int, recurrent_state_size: int, act: str = "elu", dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self._MLPBlock_0 = _MLPBlock(input_size, 1, recurrent_state_size, act, False, dtype)
        self.GRUCell_0 = GRUCell(recurrent_state_size, recurrent_state_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.GRUCell_0(h, self._MLPBlock_0(x)).float()


class WorldModelDV1(nn.Module):
    """Encoders, the Gaussian RSSM, decoders, reward and (``use_continues``)
    continue models as one module, the JAX param tree's layout."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_in_channels: int,
        mlp_in_features: int,
        cnn_output_channels: Sequence[int],
        mlp_output_dims: Sequence[int],
        image_size: int,
        actions_dim: Sequence[int],
        stochastic_size: int = 30,
        min_std: float = 0.1,
        recurrent_state_size: int = 200,
        encoder_cnn_multiplier: int = 32,
        encoder_mlp_layers: int = 4,
        encoder_dense_units: int = 400,
        decoder_cnn_multiplier: int = 32,
        decoder_mlp_layers: int = 4,
        decoder_dense_units: int = 400,
        representation_hidden_size: int = 200,
        transition_hidden_size: int = 200,
        reward_layers: int = 4,
        reward_dense_units: int = 400,
        use_continues: bool = False,
        continue_layers: int = 4,
        continue_dense_units: int = 400,
        dense_act: str = "elu",
        cnn_act: str = "relu",
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.stochastic_size, self.min_std = int(stochastic_size), float(min_std)
        self.stoch_state_size = self.stochastic_size
        self.recurrent_state_size = int(recurrent_state_size)
        self.latent_state_size = self.stochastic_size + self.recurrent_state_size
        self.use_continues = bool(use_continues)
        latent = self.latent_state_size
        # the encoder's output width: the ensemble of P2E-DV1 predicts it
        self.embedding_dim = 0
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoderDV2(self.cnn_keys, cnn_in_channels, encoder_cnn_multiplier, cnn_act, False, dtype)
            enc_dim = conv_output_side(int(image_size)) ** 2 * 8 * encoder_cnn_multiplier
            self.embedding_dim += enc_dim
            self.cnn_decoder = CNNDecoderDV2(self.cnn_keys, cnn_output_channels, decoder_cnn_multiplier, latent, enc_dim, image_size, cnn_act, False, dtype)
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoderDV2(self.mlp_keys, mlp_in_features, encoder_mlp_layers, encoder_dense_units, dense_act, False, dtype)
            self.embedding_dim += int(encoder_dense_units)
            self.mlp_decoder = MLPDecoderDV2(self.mlp_keys, mlp_output_dims, latent, decoder_mlp_layers, decoder_dense_units, dense_act, False, dtype)
        self.recurrent_model = RecurrentModelDV1(self.stochastic_size + int(sum(actions_dim)), self.recurrent_state_size, dense_act, dtype)
        self.representation_model = _Head(
            _MLPBlock(self.recurrent_state_size + self.embedding_dim, 1, representation_hidden_size, dense_act, False, dtype),
            Dense(representation_hidden_size, 2 * self.stochastic_size),
        )
        self.transition_model = _Head(
            _MLPBlock(self.recurrent_state_size, 1, transition_hidden_size, dense_act, False, dtype),
            Dense(transition_hidden_size, 2 * self.stochastic_size),
        )
        self.reward_model = _Head(_MLPBlock(latent, reward_layers, reward_dense_units, dense_act, False, dtype), Dense(reward_dense_units, 1))
        if self.use_continues:
            self.continue_model = _Head(_MLPBlock(latent, continue_layers, continue_dense_units, dense_act, False, dtype), Dense(continue_dense_units, 1))

    def encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_keys:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, -1).float()

    def decode(self, latent: torch.Tensor) -> Mapping[str, torch.Tensor]:
        out = {}
        if self.cnn_keys:
            out.update(self.cnn_decoder(latent.to(self.dtype)))
        if self.mlp_keys:
            out.update(self.mlp_decoder(latent.to(self.dtype)))
        return out

    def reward_mean(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent.to(self.dtype))

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent.to(self.dtype))

    def _stoch(self, out: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(mean, std, rsample)`` of the Gaussian state of a head's
        ``[..., 2 * stochastic_size]`` output (JAX :212-218)."""
        mean, std = out.chunk(2, -1)
        std = F.softplus(std) + self.min_std
        return mean, std, mean + std * gaussian_noise(mean, generator)

    def dynamic(
        self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, embedded: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        """One posterior step, no ``is_first`` gating (JAX :220-231):
        ``(h', z', post_mean, post_std, prior_mean, prior_std)``; the prior
        is drawn before the posterior."""
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        prior_mean, prior_std, _ = self._stoch(self.transition_model(h.to(self.dtype)), generator)
        post_mean, post_std, z = self._stoch(self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)), generator)
        return h, z, post_mean, post_std, prior_mean, prior_std

    def imagination(self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prior step in latent space; returns ``(z', h')`` (JAX :233)."""
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        _, _, z = self._stoch(self.transition_model(h.to(self.dtype)), generator)
        return z, h

    def observe_step(
        self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, obs: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The player's posterior step; returns ``(z', h')`` (JAX :240)."""
        embedded = self.encode(obs)
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        _, _, z = self._stoch(self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)), generator)
        return z, h


def rssm_scan_dv1(
    wm: WorldModelDV1, embedded: torch.Tensor, actions: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, ...]:
    """The RSSM over ``[T, B, ...]`` from zero states (``actions`` already
    the ones that led to each observation); returns time-major ``(hs,
    posteriors, post_means, post_stds, prior_means, prior_stds)``."""
    B = embedded.shape[1]
    h = embedded.new_zeros(B, wm.recurrent_state_size)
    z = embedded.new_zeros(B, wm.stochastic_size)
    out: List[Tuple[torch.Tensor, ...]] = []
    for t in range(embedded.shape[0]):
        h, z, *stats = wm.dynamic(z, h, actions[t], embedded[t], generator)
        out.append((h, z, *stats))
    return tuple(torch.stack(x) for x in zip(*out))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Dreamer-V2's init (xavier normal kernels, zero biases), then flax's
    ``GRUCell`` initialisers for each GRU cell."""
    dv2_init_weights(module, generator)
    for m in module.modules():
        if isinstance(m, GRUCell):
            m.reset_parameters(generator)


def build_world_model(cfg: Mapping[str, Any], obs_space: Any, actions_dim: Sequence[int]) -> WorldModelDV1:
    """The world model of ``cfg`` (JAX :293-320), at its precision."""
    algo = cfg["algo"]
    wm_cfg = algo["world_model"]
    cnn_keys, mlp_keys = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    return WorldModelDV1(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_in_channels=sum(_image_channels(tuple(obs_space[k].shape)) for k in cnn_keys),
        mlp_in_features=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
        cnn_output_channels=[_image_channels(tuple(obs_space[k].shape)) for k in algo["cnn_keys"]["decoder"]],
        mlp_output_dims=[int(obs_space[k].shape[0]) for k in algo["mlp_keys"]["decoder"]],
        image_size=int(cfg["env"]["screen_size"]),
        actions_dim=actions_dim,
        stochastic_size=int(wm_cfg["stochastic_size"]),
        min_std=float(wm_cfg["min_std"]),
        recurrent_state_size=int(wm_cfg["recurrent_model"]["recurrent_state_size"]),
        encoder_cnn_multiplier=int(wm_cfg["encoder"]["cnn_channels_multiplier"]),
        encoder_mlp_layers=int(wm_cfg["encoder"]["mlp_layers"]),
        encoder_dense_units=int(wm_cfg["encoder"]["dense_units"]),
        decoder_cnn_multiplier=int(wm_cfg["observation_model"]["cnn_channels_multiplier"]),
        decoder_mlp_layers=int(wm_cfg["observation_model"]["mlp_layers"]),
        decoder_dense_units=int(wm_cfg["observation_model"]["dense_units"]),
        representation_hidden_size=int(wm_cfg["representation_model"]["hidden_size"]),
        transition_hidden_size=int(wm_cfg["transition_model"]["hidden_size"]),
        reward_layers=int(wm_cfg["reward_model"]["mlp_layers"]),
        reward_dense_units=int(wm_cfg["reward_model"]["dense_units"]),
        use_continues=bool(wm_cfg["use_continues"]),
        continue_layers=int(wm_cfg["discount_model"]["mlp_layers"]),
        continue_dense_units=int(wm_cfg["discount_model"]["dense_units"]),
        dense_act=str(algo["dense_act"]),
        cnn_act=str(algo["cnn_act"]),
        dtype=compute_dtype(cfg["fabric"]["precision"]),
    )


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Mapping[str, Any],
    obs_space: Any,
    device: DeviceLike = None,
) -> Tuple[WorldModelDV1, ActorDV1, CriticDV1, PlayerDV1]:
    """World model, actor, critic and player on ``device`` (the CUDA card
    unless ``device="cpu"``), a seeded init from ``cfg["seed"]`` (weights
    from a checkpoint load through ``convert``), computing at
    ``fabric.precision``. No target critic: the critic bootstraps itself.
    The player goes where ``algo.player_device`` says when ``main`` places
    it (``dreamer_v3.place_dreamer_player``, the JAX
    ``resolve_player_device`` at :401)."""
    dev = resolve_device(device)
    wm = build_world_model(cfg, obs_space, actions_dim)
    actor = make_actor(cfg, wm.latent_state_size, actions_dim, is_continuous, layer_norm=False)
    critic = make_critic(cfg, wm.latent_state_size, layer_norm=False)
    generator = torch.Generator().manual_seed(int(cfg["seed"]))
    for module in (wm, actor, critic):
        init_weights(module, generator)
        module.to(dev)
    player = PlayerDV1(wm, actor, actions_dim, int(cfg["env"]["num_envs"]), int(cfg["seed"]), dev)
    return wm, actor, critic, player
