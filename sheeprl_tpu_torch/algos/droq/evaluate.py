"""DroQ evaluation entry point (port of ``sheeprl_tpu/algos/droq/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.evaluate import play_offpolicy_episode, vector_obs
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="droq")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy DroQ episode from a checkpoint's agent."""
    return play_offpolicy_episode(build_agent, vector_obs, fabric, cfg, state, device)
