"""SAC evaluation entry point (port of ``sheeprl_tpu/algos/sac/evaluate.py``),
and the evaluation the SAC family shares."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import Box
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


def play_offpolicy_episode(
    build: Callable[..., Tuple[Any, Any]],
    prepare: Callable[[Mapping[str, Any]], Callable[[Mapping[str, Any]], Any]],
    fabric: Any,
    cfg: Optional[Dict[str, Any]],
    state: Optional[Dict[str, Any]],
    device: DeviceLike,
) -> Tuple[float, int]:
    """Rebuild a SAC-family player from ``state["agent"]`` (the JAX
    checkpoint layout; a seeded init when ``state`` is None) with ``build``
    and play one greedy episode on observations made by ``prepare(cfg)``.
    Called as ``cli_eval`` calls it, ``(fabric, cfg, state)``, on the
    Fabric's device with the run's logger; or as ``(cfg, state,
    device=...)`` without a logger. Returns the reward sum and the steps."""
    logger = log_dir = None
    if isinstance(fabric, Fabric):
        log_dir = get_log_dir(cfg)
        logger = fabric.logger = get_logger(cfg, log_dir)
        device = fabric.device
    else:
        fabric, cfg, state = None, fabric, cfg
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(action_space, Box):
        raise ValueError("Only continuous action space is supported for the SAC family's agents")
    _, player = build(cfg, observation_space, action_space, (state or {}).get("agent"), device=device)
    result = test(player, cfg, prepare(cfg), log_dir, logger=logger)
    if logger is not None:
        logger.finalize()
    return result


def vector_obs(cfg: Mapping[str, Any]) -> Callable[[Mapping[str, Any]], Any]:
    mlp_keys = cfg["algo"]["mlp_keys"]["encoder"]
    return lambda obs: prepare_obs(obs, mlp_keys=mlp_keys)


@register_evaluation(algorithms="sac")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy SAC episode from a checkpoint's agent."""
    return play_offpolicy_episode(build_agent, vector_obs, fabric, cfg, state, device)
