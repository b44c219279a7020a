"""Dreamer-V3 evaluation entry point (port of
``sheeprl_tpu/algos/dreamer_v3/evaluate.py:13-18`` and
``sheeprl_tpu/utils/evaluation.py:35-68``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.envs.spaces import action_dims


def evaluate(cfg: Dict[str, Any], state: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Tuple[float, int]:
    """Rebuild the agent from ``state["world_model"]`` and ``state["actor"]``
    (port state dicts, see ``convert``; a seeded init when ``state`` is None)
    on ``device`` (the CUDA card unless ``device="cpu"``) and play one greedy
    episode. Returns the episode's reward sum and its number of steps."""
    env = make_env(cfg, cfg["seed"])()
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
    return test(player, cfg)
