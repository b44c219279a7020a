"""Dreamer-V3 agent (port of ``sheeprl_tpu/algos/dreamer_v3/agent.py``).

Ported here: ``_LNMLP`` (:59-76), ``CNNEncoder`` (:79-105), ``MLPEncoder``
(:108-122), ``CNNDecoder`` (:125-169), ``MLPDecoder`` (:172-188),
``RecurrentModel`` (:191-208), ``FusedRecurrentModel`` (:253-302),
``_uniform_mix``/``compute_stochastic_state`` (:305-320), ``WorldModel``
(:323-515, with the reward and continue heads, ``decode``, ``dynamic`` and
``imagination``), ``rssm_scan`` (:518-543), ``Actor`` (:546-583),
``actor_dists`` (:586-603, every head), ``_actor_unimix`` (:606-611),
``MinedojoActor`` and ``sample_minedojo_actions`` (:614-665),
``sample_actor_actions`` (:666-687), ``actor_logprob_entropy`` (:690-707),
``make_critic`` (:710-729), ``PlayerDV3`` (:732-848, the masked step
too) and ``build_agent`` (:851-996; the critic pair in ``build_critic``).
The decoders are built over the encoder's keys with the decoder keys'
sizes, as the JAX ``build_agent`` builds them (:880-881).

Layouts: images enter NHWC uint8 as in the JAX package. The encoder runs
its convolutions NCHW, takes each LayerNorm over channels, and flattens in
NHWC order, so the representation model sees the same feature order as the
JAX one. The decoder's transposed convolutions are ``nn.ConvTranspose2d``
(stride 2, ``padding=1``: flax's explicit (2, 2) padding of the dilated
input); ``convert`` flips flax's kernels to match. The recurrent model keeps
its kernels as ``[in, out]`` (flax ``Dense`` layout) because the fused CUDA
step reads them as they are.

``rssm_scan`` is a Python loop over ``dynamic``: on the card every step of
it, and of imagination, is one call of the fused step kernel (B1) when
``fused`` resolves to it.

Precision: every module takes the compute dtype of ``fabric.precision``
(``device.Precision``) and casts where the JAX module does: trunks compute
in it, LayerNorms in fp32 cast back, the heads of the representation,
transition, reward and continue models, the actor and the critic in fp32,
the decoders' outputs and ``encode``'s features are fp32, and the entry
points cast latents to the compute dtype. Parameters stay fp32, at
``bf16-true`` too (the JAX modules fix ``param_dtype=jnp.float32``). At
``bf16-mixed`` the fused step takes bf16 ``x`` and fp32 ``h`` and computes
in fp32 (as JAX ``fused=pallas``), where the plain ``RecurrentModel``
rounds its state to bf16 inside the step (as the flax cell).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from sheeprl_tpu_torch.models.blocks import ConvTranspose2d, Conv2d, Dense, LayerNorm, LayerNormGRUCell
from sheeprl_tpu_torch.ops.distributions import Independent, Normal, OneHotCategoricalStraightThrough, TanhNormal
from sheeprl_tpu_torch.ops.fused_gru import fused_recurrent_step
from sheeprl_tpu_torch.ops.math import symlog

# --------------------------------------------------------------------------- #
# initialisers (the JAX package's hafner_init, uniform_init and flax's
# lecun_normal, each drawn from an explicit generator)
# --------------------------------------------------------------------------- #


def _fans(shape: Tuple[int, ...], in_out: bool) -> Tuple[int, int]:
    if in_out:  # [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive  # [out, in, *kernel]


def variance_scaling_(
    w: torch.Tensor, scale: float, mode: str, distribution: str, generator: torch.Generator, in_out: bool = False
) -> None:
    fan_in, fan_out = _fans(tuple(w.shape), in_out)
    n = fan_in if mode == "fan_in" else (fan_in + fan_out) / 2
    with torch.no_grad():
        if distribution == "truncated_normal":
            std = math.sqrt(scale / n) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        else:
            lim = math.sqrt(3 * scale / n)
            nn.init.uniform_(w, -lim, lim, generator=generator)


def _head(in_features: int, out_features: int, uniform_scale: float, dtype: torch.dtype = torch.float32) -> Dense:
    """A Dense computing in ``dtype`` (fp32 unless given), initialised by
    ``uniform_init(uniform_scale)``, not Hafner's."""
    layer = Dense(in_features, out_features, compute_dtype=dtype)
    layer.uniform_scale = uniform_scale
    return layer


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the JAX package's scheme: Hafner's truncated normal for
    trunks and convs, ``uniform_init`` for the heads, lecun normal for the
    GRU projection, zeros for biases and ones for LayerNorm scales."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            scale = getattr(m, "uniform_scale", None)
            if scale is None:
                variance_scaling_(m.weight, 1.0, "fan_avg", "truncated_normal", generator)
            elif scale == 0.0:
                nn.init.zeros_(m.weight)
            else:
                variance_scaling_(m.weight, scale, "fan_avg", "uniform", generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, LayerNormGRUCell):
            variance_scaling_(m.kernel, 1.0, "fan_in", "truncated_normal", generator, in_out=True)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, RecurrentModel):
            variance_scaling_(m.in_kernel, 1.0, "fan_avg", "truncated_normal", generator, in_out=True)
            nn.init.zeros_(m.in_bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #


class _LNMLP(nn.Module):
    """Dense -> LayerNorm(eps) -> SiLU, repeated (the Dreamer-V3 block), the
    products in ``dtype``."""

    def __init__(
        self, in_features: int, layers: int, units: int, eps: float = 1e-3, dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        dims = [in_features] + [units] * layers
        self.linears = nn.ModuleList(Dense(a, b, compute_dtype=dtype) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(units, eps=eps) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for linear, norm in zip(self.linears, self.norms):
            x = F.silu(norm(linear(x)))
        return x


class CNNEncoder(nn.Module):
    """4-stage stride-2 conv encoder: kernel 4, channels ``[1,2,4,8] *
    multiplier``, no conv bias, LayerNorm over channels + SiLU. Takes NHWC
    uint8 images and returns features flattened in NHWC order, in ``dtype``
    (pixels normalised in it, as the JAX encoder)."""

    def __init__(
        self,
        keys: Sequence[str],
        in_channels: int,
        channels_multiplier: int,
        stages: int = 4,
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.dtype = dtype
        chans = [in_channels] + [(2**i) * channels_multiplier for i in range(stages)]
        self.convs = nn.ModuleList(
            Conv2d(a, b, kernel_size=4, stride=2, padding=1, bias=False, compute_dtype=dtype)
            for a, b in zip(chans[:-1], chans[1:])
        )
        self.norms = nn.ModuleList(LayerNorm(c, eps=eps) for c in chans[1:])

    def output_dim(self, image_size: int) -> int:
        side = image_size // (2 ** len(self.convs))
        return self.convs[-1].out_channels * side * side

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k].to(self.dtype) / 255.0 - 0.5 for k in self.keys], -1)  # NHWC
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)  # NCHW
        for conv, norm in zip(self.convs, self.norms):
            x = conv(x)
            x = F.silu(norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)


class MLPEncoder(nn.Module):
    """symlog (fp32) -> N x (Dense + LayerNorm + SiLU) in ``dtype``."""

    def __init__(
        self,
        keys: Sequence[str],
        in_features: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        symlog_inputs: bool = True,
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.dtype = dtype
        self.mlp = _LNMLP(in_features, mlp_layers, dense_units, eps, dtype)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = [obs[k].float() for k in self.keys]
        x = torch.cat([symlog(p) if self.symlog_inputs else p for p in parts], -1)
        return self.mlp(x.to(self.dtype))


# --------------------------------------------------------------------------- #
# decoders
# --------------------------------------------------------------------------- #


class CNNDecoder(nn.Module):
    """Inverse of :class:`CNNEncoder`: a Linear to a ``seed x seed x (8 *
    multiplier)`` map, ``stages - 1`` upsampling transposed convolutions with
    LayerNorm over channels and SiLU, then a plain transposed convolution
    (with bias) to the output channels, all in ``dtype``. Returns fp32 NHWC
    reconstructions by key."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        channels_multiplier: int,
        latent_size: int,
        image_size: int,
        stages: int = 4,
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.image_size = int(image_size)
        self.seed_hw = self.image_size // (2**stages)
        self.seed_ch = (2 ** (stages - 1)) * channels_multiplier
        self.linear = Dense(latent_size, self.seed_hw * self.seed_hw * self.seed_ch, compute_dtype=dtype)
        chans = [self.seed_ch] + [(2 ** (stages - 2 - i)) * channels_multiplier for i in range(stages - 1)]
        self.deconvs = nn.ModuleList(
            ConvTranspose2d(a, b, kernel_size=4, stride=2, padding=1, bias=False, compute_dtype=dtype)
            for a, b in zip(chans[:-1], chans[1:])
        )
        self.norms = nn.ModuleList(LayerNorm(c, eps=eps) for c in chans[1:])
        self.out = ConvTranspose2d(
            chans[-1], sum(self.output_channels), kernel_size=4, stride=2, padding=1, compute_dtype=dtype
        )
        self.out.uniform_scale = 1.0

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.linear(latent).reshape(-1, self.seed_hw, self.seed_hw, self.seed_ch).permute(0, 3, 1, 2)
        for deconv, norm in zip(self.deconvs, self.norms):
            x = deconv(x)
            x = F.silu(norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        x = self.out(x).permute(0, 2, 3, 1)
        x = x.reshape(*lead, self.image_size, self.image_size, sum(self.output_channels)).float()
        return dict(zip(self.keys, torch.split(x, self.output_channels, -1)))


class MLPDecoder(nn.Module):
    """An ``_LNMLP`` trunk and one linear head per key, all in ``dtype``;
    the heads' outputs cast to fp32. The heads pair ``keys`` with
    ``output_dims`` as ``zip`` does, as the JAX decoder does: with fewer
    dims than keys (decoder keys other than the encoder's) the trunk has
    fewer heads, or none."""

    def __init__(
        self,
        keys: Sequence[str],
        output_dims: Sequence[int],
        latent_size: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.dtype = dtype
        self.mlp = _LNMLP(latent_size, mlp_layers, dense_units, eps, dtype)
        self.heads = nn.ModuleDict({k: _head(dense_units, int(d), 1.0, dtype) for k, d in zip(self.keys, output_dims)})

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(latent.to(self.dtype))
        return {k: head(x).float() for k, head in self.heads.items()}


# --------------------------------------------------------------------------- #
# recurrent model
# --------------------------------------------------------------------------- #


class RecurrentModel(nn.Module):
    """Dense + LayerNorm + SiLU, then the LayerNorm-GRU cell: the RSSM step
    in plain PyTorch, computing in ``dtype`` with ``h`` cast to it and the
    new state cast back to fp32 (JAX ``RecurrentModel``)."""

    def __init__(
        self,
        input_size: int,
        recurrent_state_size: int,
        dense_units: int,
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.in_kernel = nn.Parameter(torch.empty(input_size, dense_units))  # [in, out]
        self.in_bias = nn.Parameter(torch.zeros(dense_units))
        self.in_norm = LayerNorm(dense_units, eps=eps)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        feat = F.silu(self.in_norm(x.to(dt) @ self.in_kernel.to(dt) + self.in_bias.to(dt)))
        return self.gru(h.to(dt), feat).float()


class FusedRecurrentModel(RecurrentModel):
    """:class:`RecurrentModel` whose whole step runs as the fused CUDA kernel
    (``ops.fused_gru.fused_recurrent_step``). The parameters are the same, so
    state dicts interchange between the two. ``x`` goes to the kernel in the
    type it comes in (fp32, or bf16 under ``bf16-mixed``), ``h`` in fp32;
    the kernel computes in fp32 whatever ``dtype`` is."""

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        hid = self.gru.hidden_size
        out = fused_recurrent_step(
            x.reshape(-1, x.shape[-1]).contiguous(),
            h.reshape(-1, hid).float().contiguous(),
            self.in_kernel,
            self.in_bias,
            self.in_norm.weight,
            self.in_norm.bias,
            self.gru.kernel,
            self.gru.norm.weight,
            self.gru.norm.bias,
            eps1=self.in_norm.eps,
            eps2=self.gru.norm.eps,
        )
        return out.reshape(*lead, hid)


def resolve_backend(mode: Any) -> bool:
    """``fused`` config value -> use the fused kernel? ``auto`` and
    ``pallas`` take the kernel (its wrapper computes the plain version only
    on CPU tensors), ``flax`` the plain :class:`RecurrentModel` on any
    device, the card included."""
    if mode in (False, None, "flax", "off"):
        return False
    if mode in (True, "pallas", "force") or str(mode).lower() == "auto":
        return True
    raise ValueError(f"unknown fused-recurrent mode {mode!r}")


def _uniform_mix(logits: torch.Tensor, discrete: int, unimix: float) -> torch.Tensor:
    """1% uniform mixing of the categorical; returns [..., stoch, discrete]."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    if unimix > 0.0:
        probs = F.softmax(logits, -1)
        probs = (1 - unimix) * probs + unimix / discrete
        logits = torch.log(probs)
    return logits


def compute_stochastic_state(
    logits: torch.Tensor, generator: Optional[torch.Generator] = None, sample: bool = True
) -> torch.Tensor:
    """Straight-through sample (or mode) of the [..., S, D] categorical,
    flattened to [..., S*D]."""
    dist = Independent(OneHotCategoricalStraightThrough(logits), 1)
    state = dist.rsample(generator) if sample else dist.mode
    return state.reshape(*state.shape[:-2], -1)


# --------------------------------------------------------------------------- #
# world model
# --------------------------------------------------------------------------- #


class WorldModel(nn.Module):
    """Encoders, the RSSM (recurrent, representation and transition models),
    decoders and the reward and continue heads, with the entry points
    ``encode``, ``decode``, ``reward_logits``, ``continue_logits``,
    ``initial_state``, ``dynamic``, ``imagination`` and ``observe_step``,
    computing in ``dtype`` at the JAX ``WorldModel``'s cast points."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_in_channels: int,
        mlp_in_features: int,
        image_size: int,
        actions_dim: Sequence[int],
        stochastic_size: int = 32,
        discrete_size: int = 32,
        unimix: float = 0.01,
        recurrent_state_size: int = 4096,
        recurrent_dense_units: int = 1024,
        encoder_cnn_multiplier: int = 96,
        encoder_mlp_layers: int = 5,
        encoder_dense_units: int = 1024,
        representation_hidden_size: int = 1024,
        transition_hidden_size: int = 1024,
        cnn_stages: int = 4,
        learnable_initial_recurrent_state: bool = True,
        fused_recurrent: Any = "auto",
        cnn_output_channels: Optional[Sequence[int]] = None,
        mlp_output_dims: Optional[Sequence[int]] = None,
        decoder_cnn_multiplier: int = 96,
        decoder_mlp_layers: int = 5,
        decoder_dense_units: int = 1024,
        reward_bins: int = 255,
        reward_layers: int = 5,
        reward_dense_units: int = 1024,
        continue_layers: int = 5,
        continue_dense_units: int = 1024,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.discrete_size = discrete_size
        self.unimix = unimix
        self.recurrent_state_size = recurrent_state_size
        self.stoch_state_size = stochastic_size * discrete_size
        self.latent_state_size = self.stoch_state_size + recurrent_state_size
        embed = 0
        if self.cnn_keys:
            self.cnn_encoder = CNNEncoder(
                self.cnn_keys, cnn_in_channels, encoder_cnn_multiplier, cnn_stages, dtype=dtype
            )
            embed += self.cnn_encoder.output_dim(image_size)
        if self.mlp_keys:
            self.mlp_encoder = MLPEncoder(
                self.mlp_keys, mlp_in_features, encoder_mlp_layers, encoder_dense_units, dtype=dtype
            )
            embed += encoder_dense_units
        rec_cls = FusedRecurrentModel if resolve_backend(fused_recurrent) else RecurrentModel
        self.recurrent_model = rec_cls(
            self.stoch_state_size + int(sum(actions_dim)), recurrent_state_size, recurrent_dense_units, dtype=dtype
        )
        self.representation_model = nn.Sequential(
            _LNMLP(recurrent_state_size + embed, 1, representation_hidden_size, dtype=dtype),
            _head(representation_hidden_size, self.stoch_state_size, 1.0),
        )
        self.transition_model = nn.Sequential(
            _LNMLP(recurrent_state_size, 1, transition_hidden_size, dtype=dtype),
            _head(transition_hidden_size, self.stoch_state_size, 1.0),
        )
        latent = self.latent_state_size
        if self.cnn_keys:
            out_channels = cnn_output_channels if cnn_output_channels is not None else [3] * len(self.cnn_keys)
            self.cnn_decoder = CNNDecoder(
                self.cnn_keys, out_channels, decoder_cnn_multiplier, latent, image_size, cnn_stages, dtype=dtype
            )
        if self.mlp_keys:
            if mlp_output_dims is None:
                raise ValueError("mlp_output_dims is required with mlp keys")
            self.mlp_decoder = MLPDecoder(
                self.mlp_keys, mlp_output_dims, latent, decoder_mlp_layers, decoder_dense_units, dtype=dtype
            )
        self.reward_model = nn.Sequential(
            _LNMLP(latent, reward_layers, reward_dense_units, dtype=dtype), _head(reward_dense_units, reward_bins, 0.0)
        )
        self.continue_model = nn.Sequential(
            _LNMLP(latent, continue_layers, continue_dense_units, dtype=dtype), _head(continue_dense_units, 1, 1.0)
        )
        if learnable_initial_recurrent_state:
            self.initial_recurrent_state = nn.Parameter(torch.zeros(recurrent_state_size))
        else:
            self.register_buffer("initial_recurrent_state", None)

    @property
    def fused(self) -> bool:
        return isinstance(self.recurrent_model, FusedRecurrentModel)

    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
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

    def reward_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent.to(self.dtype))

    def continue_logits(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent.to(self.dtype))

    def initial_state(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(h0 [B, H], z0 [B, S*D]): tanh of the learnt state (or zeros) and
        the mode of the transition model's prior on it."""
        if self.initial_recurrent_state is not None:
            h0 = torch.tanh(self.initial_recurrent_state)
        else:
            h0 = torch.zeros(self.recurrent_state_size, device=self.transition_model[1].weight.device)
        h0 = h0.expand(batch, self.recurrent_state_size)
        logits = _uniform_mix(self.transition_model(h0.to(self.dtype)), self.discrete_size, self.unimix)
        return h0, compute_stochastic_state(logits, sample=False)

    def dynamic(
        self,
        z: torch.Tensor,
        h: torch.Tensor,
        action: torch.Tensor,
        embedded: torch.Tensor,
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        initial: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One posterior step from the flat ``z [B, S*D]``: where
        ``is_first [B, 1]`` is 1 the state restarts from ``initial`` (default
        ``initial_state``) and the action is zeroed. Returns ``(h', z',
        posterior_logits, prior_logits)``, the logits ``[B, S, D]``."""
        action = (1 - is_first) * action
        h0, z0 = initial if initial is not None else self.initial_state(h.shape[0])
        h = (1 - is_first) * h + is_first * h0
        z = (1 - is_first) * z + is_first * z0
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        prior_logits = _uniform_mix(self.transition_model(h.to(self.dtype)), self.discrete_size, self.unimix)
        post_logits = _uniform_mix(
            self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)), self.discrete_size, self.unimix
        )
        z = compute_stochastic_state(post_logits, generator)
        return h, z, post_logits, prior_logits

    def imagination(
        self, z: torch.Tensor, h: torch.Tensor, action: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prior step in latent space; returns ``(z', h')``."""
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        prior_logits = _uniform_mix(self.transition_model(h.to(self.dtype)), self.discrete_size, self.unimix)
        return compute_stochastic_state(prior_logits, generator), h

    def observe_step(
        self,
        z: torch.Tensor,
        h: torch.Tensor,
        action: torch.Tensor,
        obs: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        sample: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode one observation and take one posterior step with no
        is_first gating (the player resets its own states). ``sample=False``
        takes the posterior's mode instead of a straight-through sample."""
        embedded = self.encode(obs)
        h = self.recurrent_model(torch.cat([z, action], -1).to(self.dtype), h)
        post_logits = _uniform_mix(
            self.representation_model(torch.cat([h, embedded], -1).to(self.dtype)), self.discrete_size, self.unimix
        )
        return compute_stochastic_state(post_logits, generator, sample), h


def rssm_scan(
    wm: WorldModel,
    embedded: torch.Tensor,
    actions: torch.Tensor,
    is_first: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RSSM over a time-major sequence (``embedded [T, B, E]``,
    ``actions [T, B, A]`` already shifted, ``is_first [T, B, 1]``), from zero
    states, one ``dynamic`` step a timestep. Returns time-major
    ``(recurrent_states, posteriors, posterior_logits, prior_logits)``."""
    T, B = embedded.shape[0], embedded.shape[1]
    dev = embedded.device
    h = torch.zeros(B, wm.recurrent_state_size, device=dev)
    z = torch.zeros(B, wm.stoch_state_size, device=dev)
    # the learnt initial state is the same at every step: computed once
    initial = wm.initial_state(B)
    hs, zs, posts, priors = [], [], [], []
    for t in range(T):
        h, z, post, prior = wm.dynamic(z, h, actions[t], embedded[t], is_first[t], generator, initial)
        hs.append(h)
        zs.append(z)
        posts.append(post)
        priors.append(prior)
    return torch.stack(hs), torch.stack(zs), torch.stack(posts), torch.stack(priors)


# --------------------------------------------------------------------------- #
# actor
# --------------------------------------------------------------------------- #


class Actor(nn.Module):
    """Dreamer-V3 actor: an ``_LNMLP`` trunk and one head per discrete action
    dim (or one ``2 * sum(actions_dim)`` head when continuous), the trunk in
    ``dtype`` and the heads in fp32. ``forward`` returns the raw head
    outputs; :func:`actor_dists` builds the distributions."""

    def __init__(
        self,
        latent_state_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        init_std: float = 2.0,
        min_std: float = 0.1,
        max_std: float = 1.0,
        dense_units: int = 1024,
        mlp_layers: int = 5,
        unimix: float = 0.01,
        action_clip: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = distribution
        self.init_std, self.min_std, self.max_std = init_std, min_std, max_std
        self.unimix, self.action_clip = unimix, action_clip
        self.resolved_distribution()  # validate early
        self.mlp = _LNMLP(latent_state_size, mlp_layers, dense_units, dtype=dtype)
        outs = [sum(self.actions_dim) * 2] if self.is_continuous else list(self.actions_dim)
        self.heads = nn.ModuleList(_head(dense_units, d, 1.0) for d in outs)

    def resolved_distribution(self) -> str:
        dist = self.distribution.lower()
        if dist not in ("auto", "normal", "tanh_normal", "discrete", "scaled_normal"):
            raise ValueError(f"unknown actor distribution: {dist}")
        if dist == "discrete" and self.is_continuous:
            raise ValueError("discrete distribution with continuous action space")
        if dist == "auto":
            dist = "scaled_normal" if self.is_continuous else "discrete"
        return dist

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.mlp(state.to(self.dtype))
        return [head(x) for head in self.heads]


def _actor_unimix(logits: torch.Tensor, unimix: float) -> torch.Tensor:
    if unimix > 0.0:
        probs = F.softmax(logits, -1)
        probs = (1 - unimix) * probs + unimix / probs.shape[-1]
        logits = torch.log(probs)
    return logits


def actor_dists(actor: Actor, pre_dist: List[torch.Tensor]) -> list:
    """The action distributions from the raw head outputs."""
    dist_type = actor.resolved_distribution()
    if actor.is_continuous:
        mean, std = pre_dist[0].chunk(2, -1)
        if dist_type == "tanh_normal":
            mean = 5 * torch.tanh(mean / 5)
            std = F.softplus(std + actor.init_std) + actor.min_std
            return [TanhNormal(mean, std)]
        if dist_type == "normal":
            return [Independent(Normal(mean, std), 1)]
        # scaled_normal (the Dreamer-V3 default)
        std = (actor.max_std - actor.min_std) * torch.sigmoid(std + actor.init_std) + actor.min_std
        return [Independent(Normal(torch.tanh(mean), std), 1)]
    return [OneHotCategoricalStraightThrough(_actor_unimix(logits, actor.unimix)) for logits in pre_dist]


def sample_actor_actions(
    actor: Actor, state: torch.Tensor, generator: Optional[torch.Generator] = None, greedy: bool = False
) -> torch.Tensor:
    """Sample (or take the mode of) the actions; returns the concatenated
    action vector. A greedy continuous actor keeps the most likely of 100
    samples; ``tanh_normal`` has no greedy rule (the reference's raises on
    its per-dimension density), and raises. Continuous actions are scaled
    into ``[-action_clip, action_clip]`` with the scale held out of the
    gradient."""
    dists = actor_dists(actor, actor(state))
    if actor.is_continuous:
        d = dists[0]
        if greedy:
            if isinstance(d, TanhNormal):
                raise NotImplementedError("greedy tanh_normal actions are not defined by the reference")
            cand = d.sample(generator, (100,))  # [100, B, A]
            idx = d.log_prob(cand).argmax(0)  # [B]
            actions = torch.take_along_dim(cand, idx[None, ..., None], dim=0)[0]
        else:
            actions = d.rsample(generator)
        if actor.action_clip > 0.0:
            clip = torch.full_like(actions, actor.action_clip)
            actions = actions * (clip / torch.maximum(clip, actions.abs())).detach()
        return actions
    return torch.cat([d.mode if greedy else d.rsample(generator) for d in dists], -1)


def actor_logprob_entropy(
    actor: Actor, states: torch.Tensor, actions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """log pi(a|s) and the entropy for stored (imagined) actions; discrete
    actions are the concatenated one-hots. ``tanh_normal`` has no entropy
    (nor has the reference's), and raises ``NotImplementedError``."""
    dists = actor_dists(actor, actor(states))
    if actor.is_continuous:
        d = dists[0]
        return d.log_prob(actions), d.entropy()
    parts = torch.split(actions, list(actor.actions_dim), -1)
    logp = sum(d.log_prob(p) for d, p in zip(dists, parts))
    ent = sum(d.entropy() for d in dists)
    return logp, ent


class MinedojoActor(Actor):
    """The actor whose discrete heads honour MineDojo's action masks at play
    time (JAX ``agent.py:614-620``): the action-type head is masked
    directly, the craft head only where the sampled action type is CRAFT
    (15), the item head by the equip/place mask for action types 16 and 17
    and by the destroy mask for 18 (:func:`sample_minedojo_actions`).
    Selected by ``algo.actor.cls``; the modules are the ``Actor``'s."""


MINEDOJO_CRAFT, MINEDOJO_EQUIP, MINEDOJO_PLACE, MINEDOJO_DESTROY = 15, 16, 17, 18


def _gumbel_uniform(generator: Optional[torch.Generator], shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Uniforms in ``[tiny, 1)`` for a Gumbel-max draw (the one place the
    parity tests inject the JAX package's)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_min(torch.finfo(u.dtype).tiny)


def _masked_head(logits: torch.Tensor, generator: Optional[torch.Generator], greedy: bool) -> torch.Tensor:
    """A straight-through one-hot of ``logits``: the mode, or the
    Gumbel-max draw of ``jax.random.categorical``."""
    d = OneHotCategoricalStraightThrough(logits)
    if greedy:
        return d.mode
    gumbel = -torch.log(-torch.log(_gumbel_uniform(generator, tuple(logits.shape), logits.device)))
    sample = F.one_hot((gumbel + logits).argmax(-1), logits.shape[-1]).to(logits.dtype)
    probs = d.probs
    return sample + (probs - probs.detach())


def sample_minedojo_actions(
    actor: Actor,
    state: torch.Tensor,
    generator: Optional[torch.Generator],
    mask: Optional[Dict[str, torch.Tensor]],
    greedy: bool = False,
) -> torch.Tensor:
    """The three MineDojo heads sampled in turn under the masks (JAX
    ``agent.py:622-665``): masked logits are ``-inf``, the action type
    sampled first decides which mask holds for the craft and item heads.
    Returns the concatenated straight-through one-hots."""
    heads = actor(state)
    neg_inf = torch.tensor(float("-inf"), device=state.device)
    logits0 = _actor_unimix(heads[0], actor.unimix)
    if mask is not None:
        logits0 = torch.where(mask["mask_action_type"].bool(), logits0, neg_inf)
    a0 = _masked_head(logits0, generator, greedy)
    func = a0.argmax(-1)
    logits1 = _actor_unimix(heads[1], actor.unimix)
    if mask is not None:
        is_craft = (func == MINEDOJO_CRAFT)[..., None]
        logits1 = torch.where(is_craft & ~mask["mask_craft_smelt"].bool(), neg_inf, logits1)
    a1 = _masked_head(logits1, generator, greedy)
    logits2 = _actor_unimix(heads[2], actor.unimix)
    if mask is not None:
        is_equip_place = ((func == MINEDOJO_EQUIP) | (func == MINEDOJO_PLACE))[..., None]
        is_destroy = (func == MINEDOJO_DESTROY)[..., None]
        logits2 = torch.where(is_equip_place & ~mask["mask_equip_place"].bool(), neg_inf, logits2)
        logits2 = torch.where(is_destroy & ~mask["mask_destroy"].bool(), neg_inf, logits2)
    a2 = _masked_head(logits2, generator, greedy)
    return torch.cat([a0, a1, a2], -1)


# --------------------------------------------------------------------------- #
# critic
# --------------------------------------------------------------------------- #


class Critic(nn.Module):
    """Two-hot critic: an ``_LNMLP`` trunk in ``dtype`` and a
    zero-initialised fp32 head of ``bins`` logits."""

    def __init__(
        self,
        latent_state_size: int,
        bins: int = 255,
        mlp_layers: int = 5,
        dense_units: int = 1024,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.mlp = _LNMLP(latent_state_size, mlp_layers, dense_units, dtype=dtype)
        self.head = _head(dense_units, bins, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(x.to(self.dtype)))


def make_critic(cfg_critic: Dict[str, Any], latent_state_size: int, dtype: torch.dtype = torch.float32) -> Critic:
    return Critic(
        latent_state_size,
        bins=int(cfg_critic["bins"]),
        mlp_layers=int(cfg_critic["mlp_layers"]),
        dense_units=int(cfg_critic["dense_units"]),
        dtype=dtype,
    )


# --------------------------------------------------------------------------- #
# player
# --------------------------------------------------------------------------- #


class PlayerDV3:
    """Keeps (h, z, previous action) per env on the device and advances them
    with one observe+act step. Only the action goes back to the host."""

    def __init__(
        self, wm: WorldModel, actor: Actor, actions_dim: Sequence[int], num_envs: int, device: torch.device
    ) -> None:
        self.wm, self.actor = wm, actor
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.num_envs = int(num_envs)
        self.device = device
        self.h: Optional[torch.Tensor] = None  # [E, H]
        self.z: Optional[torch.Tensor] = None  # [E, S*D]
        self.actions: Optional[torch.Tensor] = None  # [E, A]

    @torch.inference_mode()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        """Reset every env's state, or (``reset_envs``) only those envs'."""
        if reset_envs is None or len(reset_envs) == 0:
            self.h, self.z = self.wm.initial_state(self.num_envs)
            self.actions = torch.zeros(self.num_envs, sum(self.actions_dim), device=self.device)
            return
        mask = torch.zeros(self.num_envs, 1, dtype=torch.bool)
        mask[list(reset_envs)] = True
        mask = mask.to(self.device)
        h0, z0 = self.wm.initial_state(self.num_envs)
        self.h = torch.where(mask, h0, self.h)
        self.z = torch.where(mask, z0, self.z)
        self.actions = torch.where(mask, torch.zeros_like(self.actions), self.actions)

    @torch.inference_mode()
    def get_actions(
        self,
        obs: Dict[str, np.ndarray],
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        sample_state: bool = True,
        mask: Optional[Dict[str, np.ndarray]] = None,
    ) -> np.ndarray:
        """One observe+act step on a ``prepare_obs`` dict; keeps (h, z,
        action) on the device for the next step and returns the actions on
        the host. Images cross the bus as uint8. ``sample_state=False`` takes
        the posterior's mode in place of a sample. ``mask`` (the env's
        ``mask*`` keys) is honoured by a ``MinedojoActor`` and ignored by any
        other actor, as in the JAX player (:836-848)."""
        keys = self.wm.cnn_keys + self.wm.mlp_keys
        obs_t = {k: torch.as_tensor(obs[k]).to(self.device) for k in keys}
        z, h = self.wm.observe_step(self.z, self.h, self.actions, obs_t, generator, sample_state)
        latent = torch.cat([z, h], -1)
        if mask and isinstance(self.actor, MinedojoActor):
            mask_t = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in mask.items()}
            action = sample_minedojo_actions(self.actor, latent, generator, mask_t, greedy)
        else:
            action = sample_actor_actions(self.actor, latent, generator, greedy)
        self.actions, self.h, self.z = action, h, z
        return action.cpu().numpy()


# --------------------------------------------------------------------------- #
# build_agent
# --------------------------------------------------------------------------- #


def _image_channels(shape: Tuple[int, ...]) -> int:
    """Channels a key brings to the CNN input: frame stacks fold into channels."""
    return int(np.prod(shape[:-3]) * shape[-1]) if len(shape) >= 3 else 1


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: Any,
    world_model_state: Optional[Dict[str, torch.Tensor]] = None,
    actor_state: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[WorldModel, Actor, PlayerDV3]:
    """World model, actor and player on ``device`` (the CUDA card unless
    ``device="cpu"``). Weights are the given state dicts (see ``convert``),
    or a seeded init from ``cfg["seed"]``. The modules compute at
    ``cfg["fabric"]["precision"]``."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg["fabric"]["precision"])
    algo = cfg["algo"]
    wm_cfg = algo["world_model"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    screen = int(cfg["env"]["screen_size"])
    obs_model = wm_cfg["observation_model"]
    wm = WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_in_channels=sum(_image_channels(tuple(obs_space[k].shape)) for k in cnn_keys),
        mlp_in_features=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
        image_size=screen,
        actions_dim=actions_dim,
        stochastic_size=int(wm_cfg["stochastic_size"]),
        discrete_size=int(wm_cfg["discrete_size"]),
        unimix=float(algo["unimix"]),
        recurrent_state_size=int(wm_cfg["recurrent_model"]["recurrent_state_size"]),
        recurrent_dense_units=int(wm_cfg["recurrent_model"]["dense_units"]),
        encoder_cnn_multiplier=int(wm_cfg["encoder"]["cnn_channels_multiplier"]),
        encoder_mlp_layers=int(wm_cfg["encoder"]["mlp_layers"]),
        encoder_dense_units=int(wm_cfg["encoder"]["dense_units"]),
        representation_hidden_size=int(wm_cfg["representation_model"]["hidden_size"]),
        transition_hidden_size=int(wm_cfg["transition_model"]["hidden_size"]),
        cnn_stages=int(np.log2(screen) - np.log2(4)),
        learnable_initial_recurrent_state=bool(wm_cfg["learnable_initial_recurrent_state"]),
        fused_recurrent=wm_cfg["recurrent_model"].get("fused", "auto"),
        # the decoders are built over the encoder's keys with the decoder
        # keys' sizes, as the JAX build_agent builds them (:880-881)
        cnn_output_channels=[_image_channels(tuple(obs_space[k].shape)) for k in algo["cnn_keys"]["decoder"]],
        mlp_output_dims=[int(obs_space[k].shape[0]) for k in algo["mlp_keys"]["decoder"]],
        decoder_cnn_multiplier=int(obs_model["cnn_channels_multiplier"]),
        decoder_mlp_layers=int(obs_model["mlp_layers"]),
        decoder_dense_units=int(obs_model["dense_units"]),
        reward_bins=int(wm_cfg["reward_model"]["bins"]),
        reward_layers=int(wm_cfg["reward_model"]["mlp_layers"]),
        reward_dense_units=int(wm_cfg["reward_model"]["dense_units"]),
        continue_layers=int(wm_cfg["discount_model"]["mlp_layers"]),
        continue_dense_units=int(wm_cfg["discount_model"]["dense_units"]),
        dtype=dtype,
    )
    actor_cfg = algo["actor"]
    actor_cls = MinedojoActor if "minedojo" in str(actor_cfg.get("cls", "")).lower() else Actor
    actor = actor_cls(
        latent_state_size=wm.latent_state_size,
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        distribution=str(cfg.get("distribution", {}).get("type", "auto")),
        init_std=float(actor_cfg["init_std"]),
        min_std=float(actor_cfg["min_std"]),
        max_std=float(actor_cfg.get("max_std", 1.0)),
        dense_units=int(actor_cfg["dense_units"]),
        mlp_layers=int(actor_cfg["mlp_layers"]),
        unimix=float(algo["unimix"]),
        action_clip=float(actor_cfg["action_clip"]),
        dtype=dtype,
    )
    generator = torch.Generator().manual_seed(int(cfg["seed"]))
    for module, state in ((wm, world_model_state), (actor, actor_state)):
        if state is None:
            init_weights(module, generator)
        else:
            module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    wm.to(dev).eval()
    actor.to(dev).eval()
    player = PlayerDV3(wm, actor, actions_dim, int(cfg["env"]["num_envs"]), dev)
    return wm, actor, player


def build_critic(
    cfg: Dict[str, Any],
    latent_state_size: int,
    critic_state: Optional[Dict[str, torch.Tensor]] = None,
    target_critic_state: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[Critic, Critic]:
    """Critic and target critic on ``device`` (the CUDA card unless
    ``device="cpu"``): the given state dicts, or a seeded init from
    ``cfg["seed"] + 1`` with the target a copy of the critic; both compute
    at ``cfg["fabric"]["precision"]``."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg["fabric"]["precision"])
    critic = make_critic(cfg["algo"]["critic"], latent_state_size, dtype)
    target = make_critic(cfg["algo"]["critic"], latent_state_size, dtype)
    if critic_state is None:
        init_weights(critic, torch.Generator().manual_seed(int(cfg["seed"]) + 1))
    else:
        critic.load_state_dict({k: torch.as_tensor(v) for k, v in critic_state.items()})
    state = critic.state_dict() if target_critic_state is None else target_critic_state
    target.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    target.requires_grad_(False)
    return critic.to(dev), target.to(dev)
