"""SAC-AE agent (port of ``sheeprl_tpu/algos/sac_ae/agent.py``): the pixel
encoder and decoder, the Q ensemble and the actor on the encoder's
features, and the agent and player handles
(https://arxiv.org/abs/1910.01741).

Modules are named after the flax scopes (``algos/sac/convert.py``). The
port computes the convolutions in NCHW where flax runs NHWC: images come in
NHWC (a frame stack folded into channels, ``[B, H, W, S*C]``, as the JAX
package folds it) and are permuted on the way in; the conv trunk's map is
flattened in flax's HWC order before ``fc``, and the decoder's ``fc`` output
is read back in that order, so the ``Dense`` kernels carry over as they
are. Precision is flax's: convolutions and hidden products in the compute
dtype with fp32 parameters, the encoder's LayerNorm and ``tanh``, the
decoder's output, the vector heads, the Q head and the actor's heads in
fp32.

The decoder's last ``ConvTranspose`` (stride 2) is flax's on an input
right-padded by one pixel and cropped to ``screen_size`` (JAX :147-160):
the zero row and column add nothing but the bias to the last output row and
column, which is torch's ``output_padding=1``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACCritic, _frozen_copy, actor_action_and_log_prob, actor_greedy_action, compute_dtype_of, finite_action_bounds
from sheeprl_tpu_torch.algos.sac.convert import LOG_ALPHA, flax_init_, load_, to_flax
from sheeprl_tpu_torch.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.envs.spaces import Box
from sheeprl_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Dense, LayerNorm, get_activation

LOG_STD_MAX = 2.0
LOG_STD_MIN = -10.0
CONV_STRIDES = (2, 1, 1, 1)


class _LayerNorm(nn.Module):
    """The repo's flax LayerNorm wrapper (fp32 statistics, output in the
    input's dtype), which nests the flax ``LayerNorm_0``."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.LayerNorm_0 = LayerNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


class FlaxMLP(nn.Module):
    """The JAX package's ``MLP`` with hidden layers only (``Dense_i``, an
    optional ``LayerNorm_i``, the activation)."""

    def __init__(self, in_features: int, hidden_sizes: Sequence[int], activation: str, layer_norm: bool, compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.n = len(hidden_sizes)
        self.layer_norm = bool(layer_norm)
        self.act = get_activation(activation)
        for i, (a, b) in enumerate(zip([in_features, *hidden_sizes[:-1]], hidden_sizes)):
            setattr(self, f"Dense_{i}", Dense(a, b, compute_dtype=compute_dtype))
            if layer_norm:
                setattr(self, f"LayerNorm_{i}", _LayerNorm(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return x


def conv_hw(screen_size: int) -> int:
    """The side of the conv trunk's map: a 3x3 stride-2 conv, then three
    3x3 stride-1 convs, all VALID."""
    return (int(screen_size) - 3) // 2 + 1 - 2 * (len(CONV_STRIDES) - 1)


class SACAEEncoder(nn.Module):
    """Pixels (NHWC floats in [0, 1], the keys concatenated on channels)
    through ``Conv_0..3`` (``32 * cnn_channels_multiplier`` channels, ReLU),
    flattened in HWC order, ``fc``, an fp32 LayerNorm and ``tanh``; vectors
    through ``mlp_encoder``; the features concatenated (JAX :36-104).
    ``detach`` stops the gradient after the conv trunk and after the MLP."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_channels: int,
        mlp_in: int,
        features_dim: int = 64,
        cnn_channels_multiplier: int = 1,
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: str = "relu",
        layer_norm: bool = False,
        screen_size: int = 64,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.compute_dtype = compute_dtype
        self.conv_channels = 32 * int(cnn_channels_multiplier)
        self.conv_hw = conv_hw(screen_size)
        self.output_dim = (int(features_dim) if self.cnn_keys else 0) + (int(dense_units) if self.mlp_keys else 0)
        if self.cnn_keys:
            chans = [int(cnn_channels)] + [self.conv_channels] * len(CONV_STRIDES)
            for i, s in enumerate(CONV_STRIDES):
                setattr(self, f"Conv_{i}", Conv2d(chans[i], chans[i + 1], 3, stride=s, compute_dtype=compute_dtype))
            self.fc = Dense(self.conv_hw * self.conv_hw * self.conv_channels, int(features_dim), compute_dtype=compute_dtype)
            self.LayerNorm_0 = LayerNorm(int(features_dim), eps=1e-6)
        if self.mlp_keys:
            self.mlp_encoder = FlaxMLP(int(mlp_in), [int(dense_units)] * int(mlp_layers), dense_act, layer_norm, compute_dtype)
        flax_init_(self)

    def forward(self, obs: Mapping[str, torch.Tensor], detach: bool = False) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            x = torch.cat([obs[k].to(self.compute_dtype) for k in self.cnn_keys], -1).permute(0, 3, 1, 2)
            for i in range(len(CONV_STRIDES)):
                x = torch.relu(getattr(self, f"Conv_{i}")(x))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            if detach:
                x = x.detach()
            feats.append(torch.tanh(self.LayerNorm_0(self.fc(x).float())))
        if self.mlp_keys:
            v = self.mlp_encoder(torch.cat([obs[k].to(self.compute_dtype) for k in self.mlp_keys], -1)).float()
            feats.append(v.detach() if detach else v)
        return feats[0] if len(feats) == 1 else torch.cat(feats, -1)


class SACAEDecoder(nn.Module):
    """Features through ``fc`` to the conv map, ``ConvTranspose_0..2`` (3x3
    stride 1, ReLU) and ``to_obs`` (3x3 stride 2) to ``[B, C, H, W]`` fp32
    per CNN key; through ``mlp_decoder`` and ``head_<key>`` to each vector
    key (JAX :107-160)."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_output_channels: Sequence[int],
        mlp_output_dims: Sequence[int],
        conv_hw_: int,
        conv_channels: int,
        features_dim: int = 64,
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: str = "relu",
        layer_norm: bool = False,
        screen_size: int = 64,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.cnn_output_channels = tuple(int(c) for c in cnn_output_channels)
        self.conv_hw, self.conv_channels, self.screen_size = int(conv_hw_), int(conv_channels), int(screen_size)
        self.compute_dtype = compute_dtype
        if self.cnn_keys:
            c = self.conv_channels
            self.fc = Dense(int(features_dim), self.conv_hw * self.conv_hw * c, compute_dtype=compute_dtype)
            for i in range(3):
                setattr(self, f"ConvTranspose_{i}", ConvTranspose2d(c, c, 3, stride=1, compute_dtype=compute_dtype))
            self.to_obs = ConvTranspose2d(c, sum(self.cnn_output_channels), 3, stride=2, output_padding=1, compute_dtype=compute_dtype)
        if self.mlp_keys:
            self.mlp_decoder = FlaxMLP(int(features_dim), [int(dense_units)] * int(mlp_layers), dense_act, layer_norm, compute_dtype)
            for k, d in zip(self.mlp_keys, mlp_output_dims):
                setattr(self, f"head_{k}", Dense(int(dense_units), int(d)))
        flax_init_(self)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            hw, c = self.conv_hw, self.conv_channels
            x = self.fc(features).view(-1, hw, hw, c).permute(0, 3, 1, 2)
            for i in range(3):
                x = torch.relu(getattr(self, f"ConvTranspose_{i}")(x))
            x = self.to_obs(x)[..., : self.screen_size, : self.screen_size].float()
            out.update(zip(self.cnn_keys, torch.split(x, self.cnn_output_channels, dim=1)))
        if self.mlp_keys:
            v = self.mlp_decoder(features)
            for k in self.mlp_keys:
                out[k] = getattr(self, f"head_{k}")(v)
        return out


class SACAEAgent(nn.Module):
    """The encoder, decoder, actor and Q ensemble, the target encoder and Q
    ensemble, and ``log_alpha`` (JAX ``SACAEAgent`` :247-279)."""

    def __init__(
        self,
        encoder: SACAEEncoder,
        decoder: SACAEDecoder,
        actor: SACActor,
        qf: SACCritic,
        target_entropy: float,
        alpha: float = 0.1,
        tau: float = 0.01,
        encoder_tau: float = 0.05,
    ) -> None:
        super().__init__()
        self.encoder, self.decoder, self.actor, self.qf = encoder, decoder, actor, qf
        self.target_encoder = _frozen_copy(encoder)
        self.target_qf = _frozen_copy(qf)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
        self.target_entropy = float(target_entropy)
        self.tau, self.encoder_tau = float(tau), float(encoder_tau)
        self.num_critics = qf.num_critics

    def parts(self) -> Tuple[Tuple[str, nn.Module], ...]:
        """The JAX checkpoint's ``agent`` keys and the modules they hold."""
        return (
            ("encoder", self.encoder),
            ("decoder", self.decoder),
            ("actor", self.actor),
            ("qfs", self.qf),
            ("target_encoder", self.target_encoder),
            ("target_qfs", self.target_qf),
        )

    def flax_state(self) -> Dict[str, Any]:
        state = {key: to_flax(m, dict(m.named_parameters())) for key, m in self.parts()}
        state["log_alpha"] = LOG_ALPHA[1]({"log_alpha": self.log_alpha})
        return state

    @torch.no_grad()
    def load_flax_state(self, state: Mapping[str, Any]) -> None:
        for key, m in self.parts():
            load_(m, state[key])
        self.log_alpha.copy_(LOG_ALPHA[0](state["log_alpha"])["log_alpha"])


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """A frame stack folded into channels, as the JAX package folds it:
    ``[B, S, H, W, C] -> [B, H, W, S*C]``; ``[B, H, W, C]`` stays."""
    if x.dim() == 5:
        b, s, h, w, c = x.shape
        return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, s * c)
    return x


def encoder_inputs(batch: Mapping[str, torch.Tensor], cnn_keys: Sequence[str], mlp_keys: Sequence[str], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The encoder's input from stored observations: pixels (uint8) folded
    and divided by 255 in fp32, vectors flat in fp32 (JAX ``sac_ae.py:73-76``
    and ``utils.py:20-35``)."""
    obs = {k: fold_frames(batch[prefix + k]).float() / 255.0 for k in cnn_keys}
    obs.update({k: batch[prefix + k].reshape(batch[prefix + k].shape[0], -1).float() for k in mlp_keys})
    return obs


class SACAEPlayer:
    """The acting policy: the agent's encoder and actor on raw observations
    (JAX ``SACAEPlayer`` :282-325)."""

    def __init__(self, agent: SACAEAgent, device: torch.device) -> None:
        self.agent = agent
        self.device = device

    @torch.no_grad()
    def get_actions(self, obs: Mapping[str, np.ndarray], generator: Optional[torch.Generator] = None, greedy: bool = False) -> np.ndarray:
        enc = self.agent.encoder
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in obs.items()}
        feat = enc(encoder_inputs(batch, enc.cnn_keys, enc.mlp_keys))
        if greedy:
            return actor_greedy_action(self.agent.actor, feat).cpu().numpy()
        return actor_action_and_log_prob(self.agent.actor, feat, generator)[0].cpu().numpy()


def _channels(shape: Sequence[int]) -> int:
    """A pixel key's channels once a frame stack is folded in."""
    return int(np.prod(shape[:-3]) * shape[-1]) if len(shape) >= 3 else 1


def build_agent(
    cfg: Mapping[str, Any],
    obs_space: Any,
    action_space: Box,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
) -> Tuple[SACAEAgent, SACAEPlayer]:
    """The agent and its player on ``device`` (the card by default; JAX
    :328-444): a seeded init or ``agent_state`` (the JAX checkpoint
    layout)."""
    dev = resolve_device(device)
    algo = cfg["algo"]
    cnn_keys, mlp_keys = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    act_dim = int(np.prod(action_space.shape))
    screen = int(cfg["env"]["screen_size"])
    dtype = compute_dtype_of(cfg)
    enc_cfg, dec_cfg = algo["encoder"], algo["decoder"]
    low, high = finite_action_bounds(action_space)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg["seed"]))
        encoder = SACAEEncoder(
            cnn_keys,
            mlp_keys,
            sum(_channels(obs_space[k].shape) for k in cnn_keys),
            sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
            features_dim=int(enc_cfg["features_dim"]),
            cnn_channels_multiplier=int(enc_cfg["cnn_channels_multiplier"]),
            dense_units=int(enc_cfg["dense_units"]),
            mlp_layers=int(enc_cfg["mlp_layers"]),
            dense_act=str(enc_cfg["dense_act"]),
            layer_norm=bool(enc_cfg["layer_norm"]),
            screen_size=screen,
            compute_dtype=dtype,
        )
        decoder = SACAEDecoder(
            algo["cnn_keys"]["decoder"],
            algo["mlp_keys"]["decoder"],
            [_channels(obs_space[k].shape) for k in algo["cnn_keys"]["decoder"]],
            [int(obs_space[k].shape[0]) for k in algo["mlp_keys"]["decoder"]],
            encoder.conv_hw,
            encoder.conv_channels,
            # the decoder reads the whole feature vector, pixel and vector parts
            features_dim=encoder.output_dim,
            dense_units=int(dec_cfg["dense_units"]),
            mlp_layers=int(dec_cfg["mlp_layers"]),
            dense_act=str(dec_cfg["dense_act"]),
            layer_norm=bool(dec_cfg["layer_norm"]),
            screen_size=screen,
            compute_dtype=dtype,
        )
        actor = SACActor(
            encoder.output_dim, act_dim, int(algo["hidden_size"]), low, high, dtype, tanh_log_std=True, log_std_min=LOG_STD_MIN, log_std_max=LOG_STD_MAX
        )
        qf = SACCritic(encoder.output_dim + act_dim, int(algo["hidden_size"]), int(algo["critic"]["n"]), compute_dtype=dtype)
    agent = SACAEAgent(
        encoder,
        decoder,
        actor,
        qf,
        target_entropy=-act_dim,
        alpha=float(algo["alpha"]["alpha"]),
        tau=float(algo["tau"]),
        encoder_tau=float(enc_cfg["tau"]),
    )
    if agent_state is not None:
        agent.load_flax_state(agent_state)
    agent.to(dev)
    return agent, SACAEPlayer(agent, dev)
