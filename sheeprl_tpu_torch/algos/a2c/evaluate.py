"""A2C evaluation entry point (port of ``sheeprl_tpu/algos/a2c/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.a2c.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.evaluate import play_greedy_episode
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="a2c")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """PPO's ``evaluate`` over the A2C agent (MLP keys only): one greedy
    episode, called as ``cli_eval`` calls it or with a port state dict."""
    return play_greedy_episode(build_agent, fabric, cfg, state, device)
