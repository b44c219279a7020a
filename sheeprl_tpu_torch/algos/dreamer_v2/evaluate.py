"""Dreamer-V2 evaluation entry point (port of
``sheeprl_tpu/algos/dreamer_v2/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.convert import from_flax
from sheeprl_tpu_torch.algos.dreamer_v2.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


def evaluate_dreamer(
    fabric: Any, cfg: Optional[Dict[str, Any]], state: Optional[Dict[str, Any]], device: DeviceLike, build_agent: Callable[..., Tuple], actor_key: str = "actor"
) -> Tuple[float, int]:
    """Rebuild the world model and the actor ``state[actor_key]`` with
    ``build_agent`` (Dreamer-V2's or Dreamer-V1's, whose first two and
    last returns are the world model, the actor and the player) from a
    checkpoint (the JAX layout, either package's) and play one greedy
    episode; called as ``cli_eval`` calls an evaluation, ``(fabric, cfg,
    state)``, or as ``(cfg, state, device=...)``. Returns the episode's
    reward sum and its number of steps."""
    logger = log_dir = None
    if isinstance(fabric, Fabric):
        log_dir = get_log_dir(cfg)
        logger = fabric.logger = get_logger(cfg, log_dir)
        device = fabric.device
    else:
        fabric, cfg, state = None, fabric, cfg
    cfg["env"]["screen_size"] = 64
    cfg["env"]["frame_stack"] = 1
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test")()
    actions_dim, is_continuous = action_dims(env.action_space)
    observation_space = env.observation_space
    env.close()
    wm, actor, *_, player = build_agent(actions_dim, is_continuous, cfg, observation_space, device=device)
    if state:
        wm.load_state_dict(from_flax(wm, state["world_model"]))
        actor.load_state_dict(from_flax(actor, state[actor_key]))
    result = test(player, cfg, log_dir, logger=logger)
    if logger is not None:
        logger.finalize()
    return result


@register_evaluation(algorithms="dreamer_v2")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """One greedy episode of a Dreamer-V2 checkpoint's actor
    (:func:`evaluate_dreamer`)."""
    return evaluate_dreamer(fabric, cfg, state, device, build_agent)
