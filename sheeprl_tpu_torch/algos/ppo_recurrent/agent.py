"""Recurrent PPO agent (port of ``sheeprl_tpu/algos/ppo_recurrent/agent.py``).

``RecurrentPPOAgent``: PPO's encoders, the previous actions concatenated
to the features, an optional ``pre_rnn_mlp``, flax's ``OptimizedLSTMCell``
over a time-major ``[T, B]`` batch (``models/blocks.py::LSTMCell``), an
optional ``post_rnn_mlp``, the critic and the actor heads. ``forward``
returns the raw heads, the fp32 values and the last ``(hx, cx)`` in fp32.

Precision, as the JAX module has it (``:101-104, 142``): the carry is cast
to the compute dtype once and the LSTM runs the whole sequence in it, so at
``bf16-mixed`` ``h`` and ``c`` stay bf16 between timesteps and become fp32
only at the output. :func:`evaluate_actions_resettable` zeroes the carry
after each stored done; the JAX package calls the agent once a step there,
its carry coming back as fp32 each step, and multiplies it by ``1 - done``
in fp32. Here the carry stays in the compute dtype and is multiplied by 0
or 1 there: bf16 to fp32 and back is exact, and so is a product by 0 or 1,
so both give the same numbers, and the encoders run once over the whole
sequence.

A sampler draws from an explicit ``torch.Generator`` (PPO's
``sample_heads``). ``RecurrentPPOPlayer.rollout_actions`` replays one CUDA
graph of a policy step over static ``obs``/``prev_actions``/``hx``/``cx``
tensors on the card, as PPO's player does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import (
    CNNEncoder,
    MLPEncoder,
    _image_channels,
    evaluate_heads,
    init_weights,
    real_actions_from_onehot,
    sample_heads,
)
from sheeprl_tpu_torch.device import DeviceLike, Precision, resolve_device
from sheeprl_tpu_torch.models.blocks import MLP, Dense, LSTMCell
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.parallel.fabric import HostPlayerParams

Carry = Tuple[torch.Tensor, torch.Tensor]


class RecurrentPPOAgent(nn.Module):
    """Encoder -> (pre-MLP) -> LSTM -> (post-MLP) -> actor heads + critic
    (JAX ``:28-144``): ``forward(obs [T, B, ...], prev_actions [T, B, A],
    hx [B, H], cx [B, H], resets=None) -> (heads, values [T, B, 1] fp32,
    (hx', cx') fp32)``. ``resets [T, B, 1]`` zeroes the carry after each
    step where it is 1 (the step's own output is kept)."""

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
        encoder_layers: int = 1,
        lstm_hidden_size: int = 64,
        pre_rnn_apply: bool = False,
        pre_rnn_units: int = 64,
        pre_rnn_layer_norm: bool = True,
        post_rnn_apply: bool = False,
        post_rnn_units: int = 64,
        post_rnn_layer_norm: bool = True,
        actor_units: int = 64,
        actor_layers: int = 1,
        critic_units: int = 64,
        critic_layers: int = 1,
        dense_act: str = "relu",
        layer_norm: bool = True,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.lstm_hidden_size = int(lstm_hidden_size)
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
        x_dim = feat + sum(self.actions_dim)
        self.pre_rnn_mlp = None
        if pre_rnn_apply:
            self.pre_rnn_mlp = MLP(x_dim, (pre_rnn_units,), None, dense_act, pre_rnn_layer_norm, compute_dtype=dtype)
            x_dim = self.pre_rnn_mlp.output_dim
        self.lstm = LSTMCell(x_dim, self.lstm_hidden_size, compute_dtype=dtype)
        out_dim = self.lstm_hidden_size
        self.post_rnn_mlp = None
        if post_rnn_apply:
            self.post_rnn_mlp = MLP(out_dim, (post_rnn_units,), None, dense_act, post_rnn_layer_norm, compute_dtype=dtype)
            out_dim = self.post_rnn_mlp.output_dim
        self.critic = MLP(out_dim, (critic_units,) * critic_layers, 1, dense_act, layer_norm, compute_dtype=dtype)
        self.actor_backbone = MLP(out_dim, (actor_units,) * actor_layers, None, dense_act, layer_norm, compute_dtype=dtype)
        back = self.actor_backbone.output_dim
        if self.is_continuous:
            heads = [Dense(back, sum(self.actions_dim) * 2, compute_dtype=dtype)]
        else:
            heads = [Dense(back, d, compute_dtype=dtype) for d in self.actions_dim]
        self.actor_heads = nn.ModuleList(heads)

    def forward(
        self,
        obs: Mapping[str, torch.Tensor],
        prev_actions: torch.Tensor,
        hx: torch.Tensor,
        cx: torch.Tensor,
        resets: Optional[torch.Tensor] = None,
    ) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        t, b = prev_actions.shape[:2]
        feats = []
        if self.cnn_encoder is not None:
            flat = {k: obs[k].reshape(t * b, *obs[k].shape[2:]) for k in self.cnn_keys}
            feats.append(self.cnn_encoder(flat).reshape(t, b, -1))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs))
        feat = feats[0] if len(feats) == 1 else torch.cat(feats, -1)
        x = torch.cat([feat, prev_actions.to(feat.dtype)], -1)
        if self.pre_rnn_mlp is not None:
            x = self.pre_rnn_mlp(x)
        dt = self.dtype
        dense_i = self.lstm.input_projection(x)
        carry = (cx.to(dt), hx.to(dt))
        keep = None if resets is None else (1 - resets).to(dt)
        outs = []
        for i in range(t):
            carry = self.lstm.step(carry, dense_i[i])
            outs.append(carry[1])
            if keep is not None:
                carry = (carry[0] * keep[i], carry[1] * keep[i])
        out = torch.stack(outs)
        if self.post_rnn_mlp is not None:
            out = self.post_rnn_mlp(out)
        values = self.critic(out).float()
        a = self.actor_backbone(out)
        heads = [head(a) for head in self.actor_heads]
        new_cx, new_hx = carry
        return heads, values, (new_hx.float(), new_cx.float())


def sample_actions(
    agent: RecurrentPPOAgent,
    obs: Mapping[str, torch.Tensor],
    prev_actions: torch.Tensor,
    hx: torch.Tensor,
    cx: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rollout policy (JAX ``:155-181``): ``(actions, logprobs, values,
    hx', cx')`` over ``[1, B]`` inputs, in the buffer's action layout."""
    actor_out, values, (new_hx, new_cx) = agent(obs, prev_actions, hx, cx)
    actions, logprob = sample_heads(agent, actor_out, generator, greedy)
    return actions, logprob, values, new_hx, new_cx


def evaluate_actions(
    agent: RecurrentPPOAgent,
    obs: Mapping[str, torch.Tensor],
    prev_actions: torch.Tensor,
    hx0: torch.Tensor,
    cx0: torch.Tensor,
    actions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stored sequences re-evaluated for the update (JAX ``:184-200``):
    ``(logprobs, entropy, values)``, each ``[L, N, 1]``; the caller masks
    the padded tail."""
    actor_out, values, _ = agent(obs, prev_actions, hx0, cx0)
    return (*evaluate_heads(agent, actor_out, actions), values)


def evaluate_actions_resettable(
    agent: RecurrentPPOAgent,
    obs: Mapping[str, torch.Tensor],
    prev_actions: torch.Tensor,
    hx0: torch.Tensor,
    cx0: torch.Tensor,
    actions: torch.Tensor,
    dones: torch.Tensor,
    *,
    reset_on_done: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`evaluate_actions` for sequences that may cross episode ends
    (the fused rollout's fixed windows, JAX ``:203-244``): with
    ``reset_on_done`` the carry is zeroed after every stored done, as the
    rollout reset it."""
    actor_out, values, _ = agent(obs, prev_actions, hx0, cx0, dones if reset_on_done else None)
    return (*evaluate_heads(agent, actor_out, actions), values)


def recurrent_rollout_step(
    agent: RecurrentPPOAgent,
    obs: Mapping[str, torch.Tensor],
    prev_actions: torch.Tensor,
    hx: torch.Tensor,
    cx: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, ...]:
    """One rollout-time policy call over ``[1, E]`` inputs (JAX
    ``:247-265``): ``(actions, real_actions, logprobs, values, hx', cx')``."""
    actions, logprob, values, new_hx, new_cx = sample_actions(agent, obs, prev_actions, hx, cx, generator)
    real = real_actions_from_onehot(agent.actions_dim, agent.is_continuous, actions)
    return actions, real, logprob, values, new_hx, new_cx


class RecurrentPPOPlayer(HostPlayerParams):
    """The agent on its device for rollouts and evaluation; the caller owns
    the recurrent state. Observations come as numpy ``[E, ...]`` (pixels
    stay ``uint8`` across the bus), ``prev_actions [E, A]``, ``hx`` and
    ``cx [E, H]`` as tensors on the device; outputs drop the time axis. On
    the card ``rollout_actions`` replays one CUDA graph of
    :func:`recurrent_rollout_step` (captured at the first call, the
    generator registered with it); elsewhere it runs eagerly. Placed
    (``place_player``), it acts on its own copy of the agent."""

    _placed_attrs = ("agent",)

    def __init__(self, agent: RecurrentPPOAgent, device: torch.device) -> None:
        self.agent = agent
        self.device = device
        self._rollout: Optional[CapturedStep] = None

    def to_device(self, obs: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """``[1, E, ...]`` tensors of the agent's keys on the device."""
        keys = self.agent.cnn_keys + self.agent.mlp_keys
        return {k: torch.as_tensor(obs[k]).to(self.device, non_blocking=True)[None] for k in keys}

    @staticmethod
    def _step(agent: RecurrentPPOAgent, d: Mapping[str, torch.Tensor], generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, ...]:
        obs = {k: d[k] for k in agent.cnn_keys + agent.mlp_keys}
        out = recurrent_rollout_step(agent, obs, d["prev_actions"][None], d["hx"], d["cx"], generator)
        return tuple(x[0] for x in out[:4]) + out[4:]

    @torch.no_grad()
    def rollout_actions(
        self,
        obs: Mapping[str, np.ndarray],
        prev_actions: torch.Tensor,
        hx: torch.Tensor,
        cx: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """``(actions, real_actions, logprobs, values, hx', cx')``, each
        ``[E, ...]``."""
        if self.device.type != "cuda":
            return self._step(self.agent, {**self.to_device(obs), "prev_actions": prev_actions, "hx": hx, "cx": cx}, generator)
        if self._rollout is None or self._rollout.generators != (generator,):
            inputs = {k: v.clone() for k, v in self.to_device(obs).items()}
            inputs.update(prev_actions=prev_actions.clone(), hx=hx.clone(), cx=cx.clone())
            agent = self.agent
            self._rollout = CapturedStep(lambda d: self._step(agent, d, generator), inputs, (), generator)
        inputs = self._rollout.inputs
        for k in self.agent.cnn_keys + self.agent.mlp_keys:
            inputs[k][0].copy_(torch.as_tensor(obs[k]), non_blocking=True)
        inputs["prev_actions"].copy_(prev_actions)
        inputs["hx"].copy_(hx)
        inputs["cx"].copy_(cx)
        return self._rollout()

    @torch.no_grad()
    def get_actions(
        self,
        obs: Mapping[str, np.ndarray],
        prev_actions: torch.Tensor,
        hx: torch.Tensor,
        cx: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """``(actions, logprobs, values, hx', cx')`` of one eager step."""
        actions, logprob, values, new_hx, new_cx = sample_actions(
            self.agent, self.to_device(obs), prev_actions[None], hx, cx, generator, greedy
        )
        return actions[0], logprob[0], values[0], new_hx, new_cx

    @torch.no_grad()
    def get_values(self, obs: Mapping[str, np.ndarray], prev_actions: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
        """The critic, ``[E, 1]``."""
        return self.agent(self.to_device(obs), prev_actions[None], hx, cx)[1][0]


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Mapping[str, Any],
    obs_space: Any,
    agent_state: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[RecurrentPPOAgent, RecurrentPPOPlayer]:
    """The agent on ``device`` (the CUDA card unless ``device="cpu"``) and
    its player (JAX ``:268-366``): weights from ``agent_state`` (a state
    dict, see ``convert``) or a seeded init from ``cfg["seed"]``, then every
    parameter, the LSTM's too, cast to ``fabric.precision``'s
    ``param_dtype``."""
    dev = resolve_device(device)
    precision = Precision(str(cfg["fabric"]["precision"]))
    algo = cfg["algo"]
    rnn = algo["rnn"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    agent = RecurrentPPOAgent(
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_channels=sum(_image_channels(obs_space[k].shape) for k in cnn_keys),
        image_size=int(obs_space[cnn_keys[0]].shape[-2]) if cnn_keys else 64,
        mlp_in_features=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
        cnn_features_dim=int(algo["encoder"]["cnn_features_dim"]),
        mlp_features_dim=algo["encoder"]["mlp_features_dim"],
        encoder_units=int(algo["encoder"]["dense_units"]),
        encoder_layers=int(algo["encoder"]["mlp_layers"]),
        lstm_hidden_size=int(rnn["lstm"]["hidden_size"]),
        pre_rnn_apply=bool(rnn["pre_rnn_mlp"]["apply"]),
        pre_rnn_units=int(rnn["pre_rnn_mlp"]["dense_units"]),
        pre_rnn_layer_norm=bool(rnn["pre_rnn_mlp"]["layer_norm"]),
        post_rnn_apply=bool(rnn["post_rnn_mlp"]["apply"]),
        post_rnn_units=int(rnn["post_rnn_mlp"]["dense_units"]),
        post_rnn_layer_norm=bool(rnn["post_rnn_mlp"]["layer_norm"]),
        actor_units=int(algo["actor"]["dense_units"]),
        actor_layers=int(algo["actor"]["mlp_layers"]),
        critic_units=int(algo["critic"]["dense_units"]),
        critic_layers=int(algo["critic"]["mlp_layers"]),
        dense_act=str(algo["dense_act"]),
        layer_norm=bool(algo["layer_norm"]),
        dtype=precision.compute_dtype,
    )
    if agent_state is None:
        generator = torch.Generator().manual_seed(int(cfg["seed"]))
        init_weights(agent, generator)
        agent.lstm.reset_parameters(generator)
    else:
        agent.load_state_dict({k: torch.as_tensor(v) for k, v in agent_state.items()})
    agent.to(device=dev, dtype=precision.param_dtype)
    return agent, RecurrentPPOPlayer(agent, dev)
