"""Recurrent PPO evaluation entry point (port of
``sheeprl_tpu/algos/ppo_recurrent/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.ppo.evaluate import play_greedy_episode
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.convert import agent_from_flax
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="ppo_recurrent")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """PPO's ``evaluate`` over the recurrent agent, its converter and its
    test episode (the LSTM state carried through it)."""
    return play_greedy_episode(build_agent, fabric, cfg, state, device, agent_from_flax, test)
