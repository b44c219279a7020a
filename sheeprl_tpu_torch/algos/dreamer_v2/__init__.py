"""Dreamer-V2 (mirrors ``sheeprl_tpu/algos/dreamer_v2``): the agent, the
training loop and the evaluation, registered on import."""

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.dreamer_v2 import evaluate  # noqa: F401  (registers the evaluation)
