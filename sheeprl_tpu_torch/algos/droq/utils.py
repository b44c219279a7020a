"""DroQ helpers (port of ``sheeprl_tpu/algos/droq/utils.py``): SAC's
metrics, observation prep and test episode."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, prepare_obs, test  # noqa: F401  (the DroQ API)
from sheeprl_tpu_torch.utils.model_manager import make_log_models


# the sub-models cli_registration registers from a checkpoint
MODELS_TO_REGISTER = {"agent"}
log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
