"""PPO evaluation entry point (port of ``sheeprl_tpu/algos/ppo/evaluate.py:16-38``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="ppo")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """Rebuild the agent from ``state["agent"]`` and play one greedy
    episode. Called as ``cli_eval`` calls it, ``evaluate(fabric, cfg,
    state)`` with a loaded checkpoint (the JAX layout), on the Fabric's
    device with the run's logger; or as ``evaluate(cfg, state,
    device=...)`` with a port state dict (a seeded init when ``state`` is
    None) on ``device``, without a logger. Returns the episode's reward sum
    and its number of steps."""
    logger = log_dir = None
    if isinstance(fabric, Fabric):
        log_dir = get_log_dir(cfg)
        logger = fabric.logger = get_logger(cfg, log_dir)
        device = fabric.device
        state = {"agent": agent_from_flax(state["agent"])}
    else:
        fabric, cfg, state = None, fabric, cfg
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test")()
    observation_space = env.observation_space
    actions_dim, is_continuous = action_dims(env.action_space)
    env.close()
    _, player = build_agent(actions_dim, is_continuous, cfg, observation_space, (state or {}).get("agent"), device=device)
    result = test(player, cfg, log_dir, logger=logger)
    if logger is not None:
        logger.finalize()
    return result
