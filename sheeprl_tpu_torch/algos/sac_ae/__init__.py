"""SAC-AE (mirrors ``sheeprl_tpu/algos/sac_ae``): the pixel autoencoder
agent, its training loop and the evaluation, registered on import (the
algorithm first)."""

from sheeprl_tpu_torch.algos.sac_ae import sac_ae  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.sac_ae import evaluate  # noqa: F401  (registers the evaluation)
