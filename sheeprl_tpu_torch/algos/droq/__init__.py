"""DroQ (mirrors ``sheeprl_tpu/algos/droq``): SAC's agent with a dropout and
LayerNorm critic, its training loop and the evaluation, registered on
import (the algorithm first)."""

from sheeprl_tpu_torch.algos.droq import droq  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.droq import evaluate  # noqa: F401  (registers the evaluation)
