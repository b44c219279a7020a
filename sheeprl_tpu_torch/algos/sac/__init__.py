"""SAC (mirrors ``sheeprl_tpu/algos/sac``): the agent, the training loop
the SAC family shares and the evaluation, registered on import (the
algorithm first). ``sac_decoupled`` is not ported (ROADMAP A10)."""

from sheeprl_tpu_torch.algos.sac import sac  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.sac import evaluate  # noqa: F401  (registers the evaluation)
