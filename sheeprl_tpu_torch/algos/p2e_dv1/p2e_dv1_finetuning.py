"""Plan2Explore on Dreamer-V1, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py:57-432``): P2E-DV2's
``finetuning_main`` with Dreamer-V1's train step over the task models and
no target critic to refresh."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning import finetuning_main
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import exploration_config  # noqa: F401  (the CLI reads it here)
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_algorithm

# the model keys that must match the exploration run (JAX :64-78)
FORCED_ALGO_KEYS = (
    "gamma",
    "lmbda",
    "horizon",
    "dense_units",
    "mlp_layers",
    "dense_act",
    "cnn_act",
    "world_model",
    "actor",
    "critic",
    "cnn_keys",
    "mlp_keys",
)


def task_step(agent: Any, opts: Sequence[Any], cfg: Dict[str, Any]) -> Callable:
    """Dreamer-V1's train step over the task models."""
    return dv1.make_train_step(agent.world_model, agent.actor_task, agent.critic_task, *opts, cfg)


@register_algorithm()
def main(
    fabric: Any,
    cfg: Optional[Dict[str, Any]] = None,
    *,
    exploration_cfg: Mapping[str, Any],
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Finetune the task models of a P2E-DV1 exploration run, called as the
    CLI calls it, ``main(fabric, cfg, exploration_cfg=...)``, or as
    ``main(cfg, exploration_cfg=..., device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps."""
    return finetuning_main(fabric, cfg, device, exploration_cfg, build_agent, task_step, None, FORCED_ALGO_KEYS, dv1.METRIC_ORDER)
