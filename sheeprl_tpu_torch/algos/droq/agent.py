"""DroQ agent (port of ``sheeprl_tpu/algos/droq/agent.py``): SAC's ``build_agent``
with a critic ensemble that applies dropout (``algo.critic.dropout``) after
each hidden product and an fp32 LayerNorm after that
(https://arxiv.org/abs/2110.02034)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, SACCritic, SACPlayer  # noqa: F401  (the DroQ API)
from sheeprl_tpu_torch.algos.sac.agent import build_agent as sac_build_agent
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.spaces import Box


def build_agent(
    cfg: Mapping[str, Any],
    obs_space: Any,
    action_space: Box,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
) -> Tuple[SACAgent, SACPlayer]:
    """SAC's agent and player with DroQ's critic (JAX :25-42)."""
    critic_kwargs = {"dropout": float(cfg["algo"]["critic"].get("dropout", 0.0)), "layer_norm": True}
    return sac_build_agent(cfg, obs_space, action_space, agent_state, device, critic_kwargs)
