"""SAC-AE evaluation entry point (port of ``sheeprl_tpu/algos/sac_ae/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from sheeprl_tpu_torch.algos.sac.evaluate import play_offpolicy_episode
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import prepare_obs
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.utils.registry import register_evaluation


def pixel_obs(cfg: Mapping[str, Any]) -> Callable[[Mapping[str, Any]], Any]:
    cnn_keys, mlp_keys = cfg["algo"]["cnn_keys"]["encoder"], cfg["algo"]["mlp_keys"]["encoder"]
    return lambda obs: prepare_obs(obs, cnn_keys, mlp_keys)


@register_evaluation(algorithms="sac_ae")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy SAC-AE episode from a checkpoint's agent."""
    return play_offpolicy_episode(build_agent, pixel_obs, fabric, cfg, state, device)
