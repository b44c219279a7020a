"""A2C helpers (port of ``sheeprl_tpu/algos/a2c/utils.py``): its metrics;
the observation prep and the greedy test episode are PPO's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs, test  # noqa: F401  (the A2C API)

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
