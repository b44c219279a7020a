"""sheeprl_tpu_torch: the PyTorch and CUDA port of ``sheeprl_tpu`` for one
NVIDIA H100.

The JAX package ``sheeprl_tpu`` is the reference this package is held to.
Module names mirror it, and each module's docstring names the JAX file it
ports. The package imports ``torch`` and never JAX, flax, gymnasium, PyYAML
or ``sheeprl_tpu``. Entry points run on the CUDA card unless the caller asks
for the CPU (``device="cpu"``, or ``fabric=cpu`` on the command line); the
hand-written CUDA kernels build at first use from ``csrc/``.

Ported so far: Dreamer-V3 end to end on one card, started as the JAX
package starts it, ``python -m sheeprl_tpu_torch exp=dreamer_v3 ...`` and
``python -m sheeprl_tpu_torch.cli_eval checkpoint_path=...`` (``cli.py``):
the config engine and its copy of the config tree (``config/``,
``configs/``), the registry, a one-device ``Fabric``, the logger,
telemetry and the run registry (``utils/``, ``obs/``), the player and the
training loop (``algos.dreamer_v3``) with replay, checkpoints and
resilience, the env pipeline without gymnasium (``envs``: wrappers,
``make_env``, the sync and async vector envs, the jittable and pixel
envs), and the RSSM step as the CUDA kernel ``csrc/fused_gru.cu``;
and the model-sharded RSSM step (``ops.fused_gru.sharded_recurrent_step``)
on a (data, model) ``torch.distributed`` mesh (``parallel``), with its
projection as the second kernel of that source.
"""

__version__ = "0.1.0"
