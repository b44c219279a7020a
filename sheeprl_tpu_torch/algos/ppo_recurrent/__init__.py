"""Recurrent PPO (mirrors ``sheeprl_tpu/algos/ppo_recurrent``): the agent,
the training loop and the evaluation, registered on import (the algorithm
first)."""

from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.ppo_recurrent import evaluate  # noqa: F401  (registers the evaluation)
