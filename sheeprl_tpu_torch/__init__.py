"""sheeprl_tpu_torch: the PyTorch and CUDA port of ``sheeprl_tpu`` for one
NVIDIA H100.

The JAX package ``sheeprl_tpu`` is the reference this package is held to.
Module names mirror it, and each module's docstring names the JAX file it
ports. The package imports ``torch`` and never JAX, flax, gymnasium, PyYAML
or ``sheeprl_tpu``. Entry points run on the CUDA card unless the caller asks
for the CPU (``device="cpu"``); the hand-written CUDA kernels build at first
use from ``csrc/``.

Ported so far: the Dreamer-V3 observe+act path (``algos.dreamer_v3``), with
the RSSM step as the CUDA kernel ``csrc/fused_gru.cu``; and the model-sharded
RSSM step (``ops.fused_gru.sharded_recurrent_step``) on a (data, model)
``torch.distributed`` mesh (``parallel``), with its projection as the second
kernel of that source.
"""

__version__ = "0.1.0"
