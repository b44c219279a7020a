"""P2E-DV3 evaluation entry point (port of
``sheeprl_tpu/algos/p2e_dv3/evaluate.py``): the **task** actor of either
phase's checkpoint, ``world_model`` and ``actor_task``, through Dreamer-V3's
evaluation."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate_actor
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy episode of the task actor (``dreamer_v3.evaluate``'s
    contract, with ``state["actor_task"]``)."""
    return evaluate_actor(fabric, cfg, state, device, actor_key="actor_task")
