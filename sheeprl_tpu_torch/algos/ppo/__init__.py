"""PPO (mirrors ``sheeprl_tpu/algos/ppo``): the agent, the training loop
and the evaluation, registered on import (the algorithm first)."""

from sheeprl_tpu_torch.algos.ppo import ppo  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.ppo import evaluate  # noqa: F401  (registers the evaluation)
