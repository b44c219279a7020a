"""Dreamer-V3 evaluation entry point (port of
``sheeprl_tpu/algos/dreamer_v3/evaluate.py:13-18`` and
``sheeprl_tpu/utils/evaluation.py:35-68``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.convert import actor_from_flax, world_model_from_flax
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms="dreamer_v3")
def evaluate(
    fabric: Any, cfg: Optional[Dict[str, Any]] = None, state: Optional[Dict[str, Any]] = None, device: DeviceLike = None
) -> Tuple[float, int]:
    """:func:`evaluate_actor` of the Dreamer-V3 actor, ``state["actor"]``."""
    return evaluate_actor(fabric, cfg, state, device)


def evaluate_actor(
    fabric: Any,
    cfg: Optional[Dict[str, Any]] = None,
    state: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    actor_key: str = "actor",
) -> Tuple[float, int]:
    """Rebuild the agent from ``state["world_model"]`` and ``state[actor_key]``
    (``evaluate``: ``"actor"``) and play one greedy episode. Called as ``cli_eval`` calls it,
    ``evaluate(fabric, cfg, state)`` with a loaded checkpoint (the JAX
    layout), on the Fabric's device with the run's logger in a new
    ``version_N`` directory; or as ``evaluate(cfg, state, device=...)`` with
    port state dicts (see ``convert``; a seeded init when ``state`` is None)
    on ``device`` (the CUDA card unless ``device="cpu"``), without a
    logger. Returns the episode's reward sum and its number of
    steps."""
    logger = log_dir = None
    if isinstance(fabric, Fabric):
        log_dir = get_log_dir(cfg)
        logger = fabric.logger = get_logger(cfg, log_dir)
        device = fabric.device
        # a checkpoint holds the JAX layout (the port's and the JAX package's)
        state = {"world_model": world_model_from_flax(state["world_model"]), "actor": actor_from_flax(state[actor_key])}
    else:
        fabric, cfg, state = None, fabric, cfg
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test")()
    observation_space = env.observation_space
    actions_dim, is_continuous = action_dims(env.action_space)
    env.close()
    state = state or {}
    *_, player = build_agent(
        actions_dim,
        is_continuous,
        cfg,
        observation_space,
        state.get("world_model"),
        state.get("actor"),
        device=device,
    )
    result = test(player, cfg, log_dir, logger=logger)
    if logger is not None:
        logger.finalize()
    return result
