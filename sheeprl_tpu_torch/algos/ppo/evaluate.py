"""PPO evaluation entry point (port of ``sheeprl_tpu/algos/ppo/evaluate.py:16-38``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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
    return play_greedy_episode(build_agent, fabric, cfg, state, device)


def play_greedy_episode(
    build: Callable[..., Any],
    fabric: Any,
    cfg: Optional[Dict[str, Any]],
    state: Optional[Dict[str, Any]],
    device: DeviceLike,
    from_flax: Callable[[Any], Dict[str, Any]] = agent_from_flax,
    play: Callable[..., Tuple[float, int]] = test,
) -> Tuple[float, int]:
    """:func:`evaluate` with the agent and player from ``build`` (PPO's,
    A2C's or recurrent PPO's ``build_agent``), a checkpoint's agent read by
    ``from_flax`` and the episode played by ``play``."""
    logger = log_dir = None
    if isinstance(fabric, Fabric):
        log_dir = get_log_dir(cfg)
        logger = fabric.logger = get_logger(cfg, log_dir)
        device = fabric.device
        state = {"agent": from_flax(state["agent"])}
    else:
        fabric, cfg, state = None, fabric, cfg
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test")()
    observation_space = env.observation_space
    actions_dim, is_continuous = action_dims(env.action_space)
    env.close()
    _, player = build(actions_dim, is_continuous, cfg, observation_space, (state or {}).get("agent"), device=device)
    result = play(player, cfg, log_dir, logger=logger)
    if logger is not None:
        logger.finalize()
    return result
