"""Dreamer-V2 agent (port of ``sheeprl_tpu/algos/dreamer_v2/agent.py``:
``_MLPBlock`` :55-72, ``CNNEncoderDV2`` :75-103, ``CNNDecoderDV2``
:106-153, ``MLPEncoderDV2`` :156-172, ``MLPDecoderDV2`` :175-194,
``RecurrentModelDV2`` :197-215, ``compute_stochastic_state`` :218-224,
``WorldModelDV2`` :227-414, ``rssm_scan`` :417-442, ``ActorDV2`` :445-488,
``actor_dists`` :491-511, ``sample_actor_actions`` :514-530,
``actor_logprob_entropy`` :533-549, ``add_exploration_noise`` :552-574,
``CriticDV2`` :577-592, ``PlayerDV2`` :595-676 and ``build_agent``
:679-821).

What differs from Dreamer-V3: ELU and optional LayerNorm, VALID convs
(64 -> 31 -> 14 -> 6 -> 2) with biases and transposed convs of kernels
5, 5, 6, 6 back to 64, no unimix, a scalar ``Normal(mean, 1)`` reward and
value, an optional continue model, zero initial RSSM states and a
truncated-normal continuous actor with exploration noise. The recurrent
model steps ``models/blocks.py::LayerNormGRUCell`` (bias and LayerNorm):
it reaches no TPU kernel, so no CUDA kernel either.

Each torch submodule takes the name of its flax scope (``Dense_0``,
``LayerNorm_0``, ``Conv_0``, ``layers_0``, ``head_0``, ...), so
``convert`` maps every leaf by the module that holds it. Images enter NHWC
uint8; the convolutions run NCHW and the encoder flattens in NHWC order as
flax does. Precision follows ``device.Precision`` as Dreamer-V3's does:
the trunks compute in the compute dtype, the heads of the representation,
transition, reward and continue models, the actor and the critic in fp32;
parameters stay fp32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import _fans, variance_scaling_
from sheeprl_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from sheeprl_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Dense, LayerNorm, LayerNormGRUCell, get_activation
from sheeprl_tpu_torch.ops.distributions import Independent, Normal, OneHotCategoricalStraightThrough, TanhNormal, TruncatedNormal
from sheeprl_tpu_torch.parallel.fabric import HostPlayerParams


class _MLPBlock(nn.Module):
    """``layers`` x (``Dense_i`` -> ``LayerNorm_i`` (optional) -> act)."""

    def __init__(self, in_features: int, layers: int, units: int, act: str = "elu", layer_norm: bool = False, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.layers, self.layer_norm, self.act = int(layers), bool(layer_norm), get_activation(act)
        for i in range(self.layers):
            setattr(self, f"Dense_{i}", Dense(in_features if i == 0 else units, units, compute_dtype=dtype))
            if self.layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"Dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return x


class _Head(nn.Module):
    """flax ``nn.Sequential([_MLPBlock, Dense])``: ``layers_0``, ``layers_1``."""

    def __init__(self, block: _MLPBlock, out: Dense) -> None:
        super().__init__()
        self.layers_0, self.layers_1 = block, out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_1(self.layers_0(x))


def _channel_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def conv_output_side(side: int, stages: int = 4) -> int:
    """The side after ``stages`` VALID k4 s2 convolutions (64 -> 2)."""
    for _ in range(stages):
        side = (side - 4) // 2 + 1
    return side


class CNNEncoderDV2(nn.Module):
    """4 VALID k4 s2 convolutions of ``[1, 2, 4, 8] * multiplier`` channels
    (+ LayerNorm) + act over NHWC uint8 images, flattened in NHWC order."""

    def __init__(self, keys: Sequence[str], in_channels: int, multiplier: int, act: str = "elu", layer_norm: bool = False, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.keys, self.dtype, self.layer_norm, self.act = tuple(keys), dtype, bool(layer_norm), get_activation(act)
        chans = [in_channels] + [(2**i) * multiplier for i in range(4)]
        for i in range(4):
            setattr(self, f"Conv_{i}", Conv2d(chans[i], chans[i + 1], kernel_size=4, stride=2, compute_dtype=dtype))
            if self.layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(chans[i + 1]))

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k].to(self.dtype) / 255.0 - 0.5 for k in self.keys], -1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"Conv_{i}")(x)
            if self.layer_norm:
                x = _channel_norm(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)


class CNNDecoderDV2(nn.Module):
    """``Dense_0`` to the encoder's output size as a 1x1 map, then
    transposed convolutions of kernels 5, 5, 6, 6, stride 2, VALID, back to
    ``image_size``; returns fp32 NHWC reconstructions per key."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        multiplier: int,
        latent_size: int,
        encoder_output_dim: int,
        image_size: int,
        act: str = "elu",
        layer_norm: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.keys, self.output_channels = tuple(keys), [int(c) for c in output_channels]
        self.image_size, self.layer_norm, self.act = int(image_size), bool(layer_norm), get_activation(act)
        self.Dense_0 = Dense(latent_size, encoder_output_dim, compute_dtype=dtype)
        chans = [encoder_output_dim, 4 * multiplier, 2 * multiplier, multiplier, sum(self.output_channels)]
        for i, k in enumerate((5, 5, 6, 6)):
            setattr(self, f"ConvTranspose_{i}", ConvTranspose2d(chans[i], chans[i + 1], kernel_size=k, stride=2, compute_dtype=dtype))
            if self.layer_norm and i < 3:
                setattr(self, f"LayerNorm_{i}", LayerNorm(chans[i + 1]))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.Dense_0(latent)
        x = x.reshape(-1, x.shape[-1], 1, 1)
        for i in range(3):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            if self.layer_norm:
                x = _channel_norm(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        x = self.ConvTranspose_3(x).permute(0, 2, 3, 1)
        x = x.reshape(*lead, self.image_size, self.image_size, sum(self.output_channels)).float()
        return dict(zip(self.keys, torch.split(x, self.output_channels, -1)))


class MLPEncoderDV2(nn.Module):
    """The concatenated vector keys through ``_MLPBlock_0``."""

    def __init__(self, keys: Sequence[str], in_features: int, layers: int, units: int, act: str = "elu", layer_norm: bool = False, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.keys, self.dtype = tuple(keys), dtype
        self._MLPBlock_0 = _MLPBlock(in_features, layers, units, act, layer_norm, dtype)

    def forward(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self._MLPBlock_0(torch.cat([obs[k].float() for k in self.keys], -1).to(self.dtype))


class MLPDecoderDV2(nn.Module):
    """``_MLPBlock_0`` and one ``head_<key>`` a key, fp32 outputs."""

    def __init__(
        self, keys: Sequence[str], output_dims: Sequence[int], latent_size: int, layers: int, units: int, act: str = "elu", layer_norm: bool = False, dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        self.keys, self.dtype = tuple(keys), dtype
        self._MLPBlock_0 = _MLPBlock(latent_size, layers, units, act, layer_norm, dtype)
        for k, d in zip(self.keys, output_dims):
            setattr(self, f"head_{k}", Dense(units, int(d), compute_dtype=dtype))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self._MLPBlock_0(latent.to(self.dtype))
        return {k: getattr(self, f"head_{k}")(x).float() for k in self.keys}


class RecurrentModelDV2(nn.Module):
    """``_MLPBlock_0`` (one Dense + act) then ``LayerNormGRUCell_0`` (with
    bias, LayerNorm by ``world_model.recurrent_model.layer_norm``); the new
    state in fp32."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int, act: str = "elu", gru_layer_norm: bool = True, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self._MLPBlock_0 = _MLPBlock(input_size, 1, dense_units, act, False, dtype)
        self.LayerNormGRUCell_0 = LayerNormGRUCell(dense_units, recurrent_state_size, bias=True, layer_norm=gru_layer_norm, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        feat = self._MLPBlock_0(x)
        return self.LayerNormGRUCell_0(h.to(self.dtype), feat).float()


def compute_stochastic_state(logits: torch.Tensor, generator: Optional[torch.Generator] = None, sample: bool = True) -> torch.Tensor:
    """Straight-through sample (or mode) of the ``[..., S, D]`` categorical,
    flattened to ``[..., S*D]``; no unimix in Dreamer-V2."""
    dist = Independent(OneHotCategoricalStraightThrough(logits), 1)
    state = dist.rsample(generator) if sample else dist.mode
    return state.reshape(*state.shape[:-2], -1)


class WorldModelDV2(nn.Module):
    """Encoders, RSSM, decoders, reward and (``use_continues``) continue
    models as one module, the JAX param tree's layout."""

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
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 600,
        recurrent_dense_units: int = 400,
        gru_layer_norm: bool = True,
        encoder_cnn_multiplier: int = 48,
        encoder_mlp_layers: int = 4,
        encoder_dense_units: int = 400,
        decoder_cnn_multiplier: int = 48,
        decoder_mlp_layers: int = 4,
        decoder_dense_units: int = 400,
        representation_hidden_size: int = 600,
        transition_hidden_size: int = 600,
        reward_layers: int = 4,
        reward_dense_units: int = 400,
        use_continues: bool = False,
        continue_layers: int = 4,
        continue_dense_units: int = 400,
        dense_act: str = "elu",
        cnn_act: str = "elu",
        layer_norm: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.stochastic_size, self.discrete_size = int(stochastic_size), int(discrete_size)
        self.recurrent_state_size = int(recurrent_state_size)
        self.stoch_state_size = self.stochastic_size * self.discrete_size
        self.latent_state_size = self.stoch_state_size + self.recurrent_state_size
        self.use_continues = bool(use_continues)
        latent = self.latent_state_size
        embed = 0
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoderDV2(self.cnn_keys, cnn_in_channels, encoder_cnn_multiplier, cnn_act, layer_norm, dtype)
            enc_dim = conv_output_side(int(image_size)) ** 2 * 8 * encoder_cnn_multiplier
            embed += enc_dim
            self.cnn_decoder = CNNDecoderDV2(
                self.cnn_keys, cnn_output_channels, decoder_cnn_multiplier, latent, enc_dim, image_size, cnn_act, layer_norm, dtype
            )
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoderDV2(self.mlp_keys, mlp_in_features, encoder_mlp_layers, encoder_dense_units, dense_act, layer_norm, dtype)
            embed += encoder_dense_units
            self.mlp_decoder = MLPDecoderDV2(
                self.mlp_keys, mlp_output_dims, latent, decoder_mlp_layers, decoder_dense_units, dense_act, layer_norm, dtype
            )
        self.recurrent_model = RecurrentModelDV2(
            self.stoch_state_size + int(sum(actions_dim)), self.recurrent_state_size, recurrent_dense_units, dense_act, gru_layer_norm, dtype
        )
        self.representation_model = _Head(
            _MLPBlock(self.recurrent_state_size + embed, 1, representation_hidden_size, dense_act, layer_norm, dtype),
            Dense(representation_hidden_size, self.stoch_state_size),
        )
        self.transition_model = _Head(
            _MLPBlock(self.recurrent_state_size, 1, transition_hidden_size, dense_act, layer_norm, dtype),
            Dense(transition_hidden_size, self.stoch_state_size),
        )
        self.reward_model = _Head(_MLPBlock(latent, reward_layers, reward_dense_units, dense_act, layer_norm, dtype), Dense(reward_dense_units, 1))
        if self.use_continues:
            self.continue_model = _Head(
                _MLPBlock(latent, continue_layers, continue_dense_units, dense_act, layer_norm, dtype), Dense(continue_dense_units, 1)
            )

    def encode(self, obs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            feats.append(self.cnn_encoder(obs))
        if self.mlp_keys:
            feats.append(self.mlp_encoder(obs))
        return torch.cat(feats, -1).float()

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            out.update(self.cnn_decoder(latent.to(self.dtype)))
        if self.mlp_keys:
            out.update(self.mlp_decoder(latent.to(self.dtype)))
        return out

    def reward_mean(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent.to(self.dtype))

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent.to(self.dtype))

    def _stoch_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.reshape(*logits.shape[:-1], self.stochastic_size, self.discrete_size)

    def dynamic(
        self,
        z: torch.Tensor,
        h: torch.Tensor,
        action: torch.Tensor,
        embedded: torch.Tensor,
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One posterior step from zero states where ``is_first [B, 1]`` is
        1; returns ``(h', z', posterior_logits, prior_logits)``, the logits
        ``[B, S, D]``."""
        action = (1 - is_first) * action
        z = (1 - is_first) * z
        h = (1 - is_first) * h
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        prior_logits = self._stoch_logits(self.transition_model(h.to(self.dtype)))
        post_logits = self._stoch_logits(self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)))
        z = compute_stochastic_state(post_logits, generator)
        return h, z, post_logits, prior_logits

    def imagination(self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prior step in latent space; returns ``(z', h')``."""
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        prior_logits = self._stoch_logits(self.transition_model(h.to(self.dtype)))
        return compute_stochastic_state(prior_logits, generator), h

    def observe_step(
        self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, obs: Mapping[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The player's posterior step; returns ``(z', h')``."""
        embedded = self.encode(obs)
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        post_logits = self._stoch_logits(self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)))
        return compute_stochastic_state(post_logits, generator), h


def rssm_scan(
    wm: WorldModelDV2, embedded: torch.Tensor, actions: torch.Tensor, is_first: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RSSM over ``[T, B, ...]`` (``actions`` already the ones that led
    to each observation) from zero states; returns time-major
    ``(recurrent_states, posteriors, posterior_logits, prior_logits)``."""
    B = embedded.shape[1]
    h = embedded.new_zeros(B, wm.recurrent_state_size)
    z = embedded.new_zeros(B, wm.stoch_state_size)
    out: List[Tuple[torch.Tensor, ...]] = []
    for t in range(embedded.shape[0]):
        h, z, post, prior = wm.dynamic(z, h, actions[t], embedded[t], is_first[t], generator)
        out.append((h, z, post, prior))
    return tuple(torch.stack(x) for x in zip(*out))


class ActorDV2(nn.Module):
    """``_MLPBlock_0`` and the heads (``head_0`` of ``2 * sum(actions_dim)``
    for a continuous space, ``head_i`` a discrete dimension), fp32."""

    def __init__(
        self,
        latent_state_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        init_std: float = 0.0,
        min_std: float = 0.1,
        dense_units: int = 400,
        mlp_layers: int = 4,
        act: str = "elu",
        layer_norm: bool = False,
        expl_amount: float = 0.0,
        expl_decay: float = 0.0,
        expl_min: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = str(distribution)
        self.init_std, self.min_std = float(init_std), float(min_std)
        self.expl_amount, self.expl_decay, self.expl_min = float(expl_amount), float(expl_decay), float(expl_min)
        self.resolved_distribution()
        self._MLPBlock_0 = _MLPBlock(latent_state_size, mlp_layers, dense_units, act, layer_norm, dtype)
        outs = [sum(self.actions_dim) * 2] if self.is_continuous else list(self.actions_dim)
        for i, d in enumerate(outs):
            setattr(self, f"head_{i}", Dense(dense_units, d))
        self.n_heads = len(outs)

    def resolved_distribution(self) -> str:
        dist = self.distribution.lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
            raise ValueError(f"unknown actor distribution: {dist}")
        if dist == "discrete" and self.is_continuous:
            raise ValueError("discrete distribution with continuous action space")
        if dist == "auto":
            dist = "trunc_normal" if self.is_continuous else "discrete"
        return dist

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self._MLPBlock_0(state.to(self.dtype))
        return [getattr(self, f"head_{i}")(x) for i in range(self.n_heads)]

    def get_expl_amount(self, step: int) -> float:
        amount = self.expl_amount
        if self.expl_decay:
            amount *= 0.5 ** (float(step) / self.expl_decay)
        return max(amount, self.expl_min)


def actor_dists(actor: ActorDV2, pre_dist: List[torch.Tensor]) -> List[Any]:
    """The action distributions of the heads' outputs (JAX :491-511)."""
    dist_type = actor.resolved_distribution()
    if actor.is_continuous:
        mean, std = pre_dist[0].chunk(2, -1)
        if dist_type == "tanh_normal":
            mean = 5 * torch.tanh(mean / 5)
            std = F.softplus(std + actor.init_std) + actor.min_std
            return [TanhNormal(mean, std)]
        if dist_type == "normal":
            return [Independent(Normal(mean, std), 1)]
        std = 2 * torch.sigmoid((std + actor.init_std) / 2) + actor.min_std
        mean = torch.tanh(mean)
        return [Independent(TruncatedNormal(mean, std, -torch.ones_like(mean), torch.ones_like(mean)), 1)]
    return [OneHotCategoricalStraightThrough(logits) for logits in pre_dist]


def sample_actor_actions(actor: ActorDV2, state: torch.Tensor, generator: Optional[torch.Generator] = None, greedy: bool = False) -> torch.Tensor:
    """Sampled actions (greedy: the mode of the discrete heads, the most
    likely of 100 continuous draws), concatenated (JAX :514-530)."""
    dists = actor_dists(actor, actor(state))
    if actor.is_continuous:
        d = dists[0]
        if greedy:
            cand = d.sample(generator, (100,))
            idx = d.log_prob(cand).argmax(0)
            return cand.gather(0, idx[None, ..., None].expand(1, *cand.shape[1:]))[0]
        return d.rsample(generator)
    return torch.cat([d.mode if greedy else d.rsample(generator) for d in dists], -1)


def actor_logprob_entropy(actor: ActorDV2, states: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log pi(a|s) and the entropy at stored actions (zeros where the
    distribution has no entropy)."""
    dists = actor_dists(actor, actor(states))
    if actor.is_continuous:
        d = dists[0]
        try:
            ent = d.entropy()
        except NotImplementedError:
            ent = states.new_zeros(states.shape[:-1])
        return d.log_prob(actions), ent
    parts = torch.split(actions, list(actor.actions_dim), -1)
    logp = sum(d.log_prob(p) for d, p in zip(dists, parts))
    ent = sum(d.entropy() for d in dists)
    return logp, ent


def add_exploration_noise(actor: ActorDV2, actions: np.ndarray, actions_dim: Sequence[int], step: int, rng: np.random.Generator) -> np.ndarray:
    """Host exploration noise (JAX :552-574): Gaussian jitter clipped to
    [-1, 1] for continuous actions, a uniform resample with probability
    ``expl_amount`` for each discrete one-hot."""
    expl_amount = actor.get_expl_amount(step)
    if expl_amount <= 0.0:
        return actions
    if actor.is_continuous:
        return np.clip(rng.normal(actions, expl_amount), -1, 1).astype(np.float32)
    out = []
    for part in np.split(actions, np.cumsum(actions_dim)[:-1], axis=-1):
        d = part.shape[-1]
        sample = np.eye(d, dtype=part.dtype)[rng.integers(0, d, part.shape[:-1])]
        mask = (rng.random(part.shape[:-1]) < expl_amount)[..., None]
        out.append(np.where(mask, sample, part))
    return np.concatenate(out, axis=-1)


class CriticDV2(nn.Module):
    """``_MLPBlock_0`` and the fp32 scalar head ``Dense_0``: the mean of
    ``Normal(mean, 1)``."""

    def __init__(self, latent_state_size: int, mlp_layers: int = 4, dense_units: int = 400, act: str = "elu", layer_norm: bool = False, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self._MLPBlock_0 = _MLPBlock(latent_state_size, mlp_layers, dense_units, act, layer_norm, dtype)
        self.Dense_0 = Dense(dense_units, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self._MLPBlock_0(x.to(self.dtype)))


class PlayerDV2(HostPlayerParams):
    """Per-env ``(h, z, previous action)`` on the player's device, advanced
    by one observe+act step; zero initial states; the actions (with the
    actor's exploration noise when asked, from a numpy generator seeded by
    the run) go back to the host and are the next step's previous action.
    Placed on another device (``place_player``), it acts on its own copy of
    the world model's acting modules and of the actor, streamed after each
    train window."""

    _placed_attrs = ("wm", "actor")
    _placed_prefixes = {"wm": ("cnn_encoder.", "mlp_encoder.", "recurrent_model.", "representation_model.")}

    def __init__(self, wm: WorldModelDV2, actor: ActorDV2, actions_dim: Sequence[int], num_envs: int, seed: int = 0, device: Optional[torch.device] = None) -> None:
        self.wm, self.actor = wm, actor
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.num_envs = int(num_envs)
        self.device = device
        self.expl_rng = np.random.default_rng(seed)
        self.h: Optional[torch.Tensor] = None
        self.z: Optional[torch.Tensor] = None
        self.actions: Optional[torch.Tensor] = None

    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        if reset_envs is None or len(reset_envs) == 0:
            self.h = torch.zeros(self.num_envs, self.wm.recurrent_state_size, device=self.device)
            self.z = torch.zeros(self.num_envs, self.wm.stoch_state_size, device=self.device)
            self.actions = torch.zeros(self.num_envs, sum(self.actions_dim), device=self.device)
            return
        keep = torch.ones(self.num_envs, 1)
        keep[list(reset_envs)] = 0.0
        keep = keep.to(self.device)
        self.h, self.z, self.actions = self.h * keep, self.z * keep, self.actions * keep

    @torch.inference_mode()
    def get_actions(
        self,
        obs: Mapping[str, np.ndarray],
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        expl_step: int = 0,
        with_exploration: bool = False,
        mask: Any = None,
    ) -> np.ndarray:
        self.poll_params()
        keys = self.wm.cnn_keys + self.wm.mlp_keys
        obs_t = {k: torch.as_tensor(np.asarray(obs[k])).to(self.device) for k in keys}
        self.z, self.h = self.wm.observe_step(self.z, self.h, self.actions, obs_t, generator)
        action = sample_actor_actions(self.actor, torch.cat([self.z, self.h], -1), generator, greedy).cpu().numpy()
        if with_exploration:
            action = add_exploration_noise(self.actor, action, self.actions_dim, expl_step, self.expl_rng)
        self.actions = torch.as_tensor(np.asarray(action, np.float32)).to(self.device)
        return action


def _image_channels(shape: Sequence[int]) -> int:
    return int(np.prod(shape[:-3]) * shape[-1]) if len(shape) >= 3 else 1


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX modules' init from an explicit generator: xavier normal
    kernels (fan average, normal) for every Dense and convolution, lecun
    normal for the GRU projection (flax's default Dense), zero biases, unit
    LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in, fan_out = _fans(tuple(m.weight.shape), False)
            with torch.no_grad():
                nn.init.normal_(m.weight, 0.0, (2.0 / (fan_in + fan_out)) ** 0.5, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, LayerNormGRUCell):
            variance_scaling_(m.kernel, 1.0, "fan_in", "truncated_normal", generator, in_out=True)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def make_actor(cfg: Mapping[str, Any], latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool, layer_norm: Optional[bool] = None) -> ActorDV2:
    """The actor of ``cfg`` (JAX :738-753), at its precision; LayerNorm by
    ``algo.actor.layer_norm`` unless ``layer_norm`` is given (Dreamer-V1's
    is off)."""
    actor_cfg = cfg["algo"]["actor"]
    return ActorDV2(
        latent_state_size=latent_state_size,
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        distribution=str((cfg.get("distribution") or {}).get("type", "auto")),
        init_std=float(actor_cfg["init_std"]),
        min_std=float(actor_cfg["min_std"]),
        dense_units=int(actor_cfg["dense_units"]),
        mlp_layers=int(actor_cfg["mlp_layers"]),
        act=str(actor_cfg["dense_act"]),
        layer_norm=bool(actor_cfg["layer_norm"]) if layer_norm is None else layer_norm,
        expl_amount=float(actor_cfg.get("expl_amount", 0.0) or 0.0),
        expl_decay=float(actor_cfg.get("expl_decay", 0.0) or 0.0),
        expl_min=float(actor_cfg.get("expl_min", 0.0) or 0.0),
        dtype=compute_dtype(cfg["fabric"]["precision"]),
    )


def make_critic(cfg: Mapping[str, Any], latent_state_size: int, layer_norm: Optional[bool] = None) -> CriticDV2:
    """A critic of ``cfg`` (JAX :754-761), at its precision; LayerNorm as
    :func:`make_actor`'s."""
    critic_cfg = cfg["algo"]["critic"]
    return CriticDV2(
        latent_state_size,
        mlp_layers=int(critic_cfg["mlp_layers"]),
        dense_units=int(critic_cfg["dense_units"]),
        act=str(critic_cfg["dense_act"]),
        layer_norm=bool(critic_cfg["layer_norm"]) if layer_norm is None else layer_norm,
        dtype=compute_dtype(cfg["fabric"]["precision"]),
    )


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Mapping[str, Any],
    obs_space: Any,
    world_model_state: Optional[Mapping[str, torch.Tensor]] = None,
    actor_state: Optional[Mapping[str, torch.Tensor]] = None,
    critic_state: Optional[Mapping[str, torch.Tensor]] = None,
    target_critic_state: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[WorldModelDV2, ActorDV2, CriticDV2, CriticDV2, PlayerDV2]:
    """World model, actor, critic, target critic and player on ``device``
    (the CUDA card unless ``device="cpu"``), from state dicts (``convert``)
    or a seeded init from ``cfg["seed"]`` (the target a copy of the
    critic), computing at ``fabric.precision``."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg["fabric"]["precision"])
    algo = cfg["algo"]
    wm_cfg = algo["world_model"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    wm = WorldModelDV2(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_in_channels=sum(_image_channels(tuple(obs_space[k].shape)) for k in cnn_keys),
        mlp_in_features=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
        cnn_output_channels=[_image_channels(tuple(obs_space[k].shape)) for k in algo["cnn_keys"]["decoder"]],
        mlp_output_dims=[int(obs_space[k].shape[0]) for k in algo["mlp_keys"]["decoder"]],
        image_size=int(cfg["env"]["screen_size"]),
        actions_dim=actions_dim,
        stochastic_size=int(wm_cfg["stochastic_size"]),
        discrete_size=int(wm_cfg["discrete_size"]),
        recurrent_state_size=int(wm_cfg["recurrent_model"]["recurrent_state_size"]),
        recurrent_dense_units=int(wm_cfg["recurrent_model"]["dense_units"]),
        gru_layer_norm=bool(wm_cfg["recurrent_model"]["layer_norm"]),
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
        layer_norm=bool(algo["layer_norm"]),
        dtype=dtype,
    )
    actor = make_actor(cfg, wm.latent_state_size, actions_dim, is_continuous)
    critic = make_critic(cfg, wm.latent_state_size)
    target_critic = make_critic(cfg, wm.latent_state_size)
    generator = torch.Generator().manual_seed(int(cfg["seed"]))
    for module, state in ((wm, world_model_state), (actor, actor_state), (critic, critic_state)):
        if state is None:
            init_weights(module, generator)
        else:
            module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    target_critic.load_state_dict(critic.state_dict() if target_critic_state is None else {k: torch.as_tensor(v) for k, v in target_critic_state.items()})
    for p in target_critic.parameters():
        p.requires_grad_(False)
    for m in (wm, actor, critic, target_critic):
        m.to(dev)
    player = PlayerDV2(wm, actor, actions_dim, int(cfg["env"]["num_envs"]), int(cfg["seed"]), dev)
    return wm, actor, critic, target_critic, player
