"""P2E-DV1 helpers (port of ``sheeprl_tpu/algos/p2e_dv1/utils.py``): the
exploration metric names with the plain Dreamer-V1 ones the finetuning
logs, and Dreamer-V1's ``prepare_obs`` and ``test``."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v1.utils import prepare_obs, test  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_common import DREAMER_FINETUNING_KEYS, P2E_EXPLORATION_KEYS
from sheeprl_tpu_torch.utils.model_manager import make_log_models

AGGREGATOR_KEYS = set(P2E_EXPLORATION_KEYS | DREAMER_FINETUNING_KEYS)
MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "critic_exploration",
    "actor_task",
    "critic_task",
}

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "log_models_from_checkpoint", "prepare_obs", "test"]

log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
