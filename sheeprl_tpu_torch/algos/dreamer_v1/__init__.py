"""Dreamer-V1 (mirrors ``sheeprl_tpu/algos/dreamer_v1``): the agent, the
training loop and the evaluation, registered on import."""

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.dreamer_v1 import evaluate  # noqa: F401  (registers the evaluation)
