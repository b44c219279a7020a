"""Dreamer-V1 helpers (port of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
the aggregator's keys and, as in the JAX package, Dreamer-V3's
``prepare_obs`` and ``test``, which the Dreamer-V1 player serves."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v2.utils import AGGREGATOR_KEYS as _DV2_AGGREGATOR_KEYS
from sheeprl_tpu_torch.algos.dreamer_v2.utils import prepare_obs, test  # noqa: F401
from sheeprl_tpu_torch.utils.model_manager import make_log_models

AGGREGATOR_KEYS = set(_DV2_AGGREGATOR_KEYS) | {"Params/exploration_amount"}
MODELS_TO_REGISTER = {"world_model", "actor", "critic"}

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "log_models_from_checkpoint", "prepare_obs", "test"]

log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
