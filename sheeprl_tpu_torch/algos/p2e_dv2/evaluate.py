"""P2E-DV2 evaluation entry point (port of
``sheeprl_tpu/algos/p2e_dv2/evaluate.py``): the **task** actor of either
phase's checkpoint, ``world_model`` and ``actor_task``, through Dreamer-V2's
evaluation."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import evaluate_dreamer
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["p2e_dv2_exploration", "p2e_dv2_finetuning"])
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy episode of the task actor (``dreamer_v2.evaluate``'s
    contract, with ``state["actor_task"]``)."""
    return evaluate_dreamer(fabric, cfg, state, device, build_agent, actor_key="actor_task")
