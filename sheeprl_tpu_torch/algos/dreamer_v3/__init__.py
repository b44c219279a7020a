"""Dreamer-V3 (mirrors ``sheeprl_tpu/algos/dreamer_v3``): the player, the
training loop and the evaluation, registered on import."""

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate  # noqa: F401  (registers the evaluation)
