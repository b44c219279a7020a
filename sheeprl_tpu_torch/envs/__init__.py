"""Environments of the port (mirrors ``sheeprl_tpu/envs``), with no
gymnasium: the spaces, the wrappers and ``make_env`` pipeline, the ``sync``
and ``async`` vector envs, the pure torch twins of CartPole and Pendulum
and the pixel envs rendered from them, PixelCatcher and the dummy envs.
Images are NHWC uint8, as in the JAX package."""

from sheeprl_tpu_torch.envs.factory import build_vector_env, get_dummy_env, make_env, resolve_env_backend
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    FrameStack,
    GrayscaleRenderWrapper,
    MaskVelocityWrapper,
    RestartOnException,
    RewardAsObservationWrapper,
)

# the torch twins load on first use: an async env worker that builds a
# numpy env (PixelCatcher, the dummy envs) never imports torch
_JITTABLE = (
    "JittableEnvSpec",
    "StepOut",
    "TorchCartPole",
    "TorchPendulum",
    "get_jittable_env",
    "make_cartpole_spec",
    "make_pendulum_spec",
    "register_jittable_env",
)


def __getattr__(name: str):
    if name in _JITTABLE:
        from sheeprl_tpu_torch.envs import jittable

        return getattr(jittable, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ActionRepeat",
    "FrameStack",
    "JittableEnvSpec",
    "StepOut",
    "TorchCartPole",
    "TorchPendulum",
    "get_jittable_env",
    "make_cartpole_spec",
    "make_pendulum_spec",
    "register_jittable_env",
    "build_vector_env",
    "resolve_env_backend",
    "GrayscaleRenderWrapper",
    "MaskVelocityWrapper",
    "RestartOnException",
    "RewardAsObservationWrapper",
    "get_dummy_env",
    "make_env",
]
