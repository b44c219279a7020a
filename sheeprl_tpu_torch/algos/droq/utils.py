"""DroQ helpers (port of ``sheeprl_tpu/algos/droq/utils.py``): SAC's
metrics, observation prep and test episode."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, prepare_obs, test  # noqa: F401  (the DroQ API)
