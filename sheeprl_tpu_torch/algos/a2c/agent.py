"""A2C agent (port of ``sheeprl_tpu/algos/a2c/agent.py:21-59``): the PPO
agent over the vector keys only, with PPO's sampling and evaluation."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent as A2CAgent
from sheeprl_tpu_torch.algos.ppo.agent import PPOPlayer as A2CPlayer
from sheeprl_tpu_torch.algos.ppo.agent import build_agent as build_ppo_agent
from sheeprl_tpu_torch.algos.ppo.agent import evaluate_actions, sample_actions  # noqa: F401  (the A2C API)
from sheeprl_tpu_torch.device import DeviceLike


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Mapping[str, Any],
    obs_space: Any,
    agent_state: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Tuple[A2CAgent, A2CPlayer]:
    """The PPO agent with no CNN encoder, whatever ``algo.cnn_keys`` says
    (JAX ``agent.py:30-31``), and its player."""
    algo = dict(cfg["algo"])
    algo["cnn_keys"] = {"encoder": []}
    return build_ppo_agent(actions_dim, is_continuous, {**cfg, "algo": algo}, obs_space, agent_state, device)
