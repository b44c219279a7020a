"""A2C (mirrors ``sheeprl_tpu/algos/a2c``): the agent, the training loop
and the evaluation, registered on import (the algorithm first)."""

from sheeprl_tpu_torch.algos.a2c import a2c  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.a2c import evaluate  # noqa: F401  (registers the evaluation)
