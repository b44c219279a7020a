"""Dreamer-V2 helpers (port of ``sheeprl_tpu/algos/dreamer_v2/utils.py``):
the aggregator's keys and, as in the JAX package, Dreamer-V3's
``prepare_obs`` and ``test`` (:15), which the Dreamer-V2 player serves."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test as _dv3_test
from sheeprl_tpu_torch.utils.model_manager import make_log_models

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "log_models_from_checkpoint", "prepare_obs", "test"]


def test(
    player: Any, cfg: Dict[str, Any], log_dir: Optional[str] = None, test_name: str = "", greedy: bool = True, logger: Any = None
) -> Tuple[float, int]:
    """One frozen-policy episode (Dreamer-V3's ``test``): its reward sum and
    its number of steps."""
    return _dv3_test(player, cfg, log_dir, test_name=test_name, greedy=greedy, logger=logger)

log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
