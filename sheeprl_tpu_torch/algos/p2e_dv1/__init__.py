"""Plan2Explore on Dreamer-V1 (mirrors ``sheeprl_tpu/algos/p2e_dv1``): the
exploration and finetuning entry points and their evaluation, registered on
import."""

from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning  # noqa: F401  (registers the algorithm)
from sheeprl_tpu_torch.algos.p2e_dv1 import evaluate  # noqa: F401  (registers the evaluation)
