"""Dreamer-V1 evaluation entry point (port of
``sheeprl_tpu/algos/dreamer_v1/evaluate.py``): Dreamer-V2's evaluation over
the Dreamer-V1 agent."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import evaluate_dreamer
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="dreamer_v1")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy episode of a Dreamer-V1 checkpoint's actor, called as
    ``cli_eval`` calls it, ``evaluate(fabric, cfg, state)``, or as
    ``evaluate(cfg, state, device=...)``."""
    return evaluate_dreamer(fabric, cfg, state, device, build_agent)
