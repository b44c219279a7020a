"""P2E-DV3 helpers (port of ``sheeprl_tpu/algos/p2e_dv3/utils.py``).

The finetuning entry point logs the plain Dreamer-V3 metric set; both entry
points share this module's ``AGGREGATOR_KEYS`` for the CLI's metric
whitelist, so the union covers the finetuning names too. The exploration
entry point expands the generic exploration names to one per exploration
critic.
"""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS as _DV3_AGGREGATOR_KEYS
from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_common import P2E_EXPLORATION_KEYS
from sheeprl_tpu_torch.utils.model_manager import make_log_models

AGGREGATOR_KEYS_FINETUNING = set(_DV3_AGGREGATOR_KEYS)
AGGREGATOR_KEYS = set(P2E_EXPLORATION_KEYS) | AGGREGATOR_KEYS_FINETUNING
MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "moments_task",
}

__all__ = ["AGGREGATOR_KEYS", "AGGREGATOR_KEYS_FINETUNING", "MODELS_TO_REGISTER", "log_models_from_checkpoint", "prepare_obs", "test"]

log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
