"""Plan2Explore on Dreamer-V2 (mirrors ``sheeprl_tpu/algos/p2e_dv2``): the
exploration and finetuning entry points and their evaluation, registered on
import."""

from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.p2e_dv2 import evaluate  # noqa: F401  (registers the evaluation)
