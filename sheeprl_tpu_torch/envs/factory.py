"""``make_env`` / ``build_vector_env`` (port of
``sheeprl_tpu/envs/factory.py``).

``make_env`` returns a thunk that instantiates ``env.wrapper`` (a
``_target_`` node, through the port's config engine) and applies the JAX
pipeline in its order: action repeat → velocity masking →
dict-ification → image resize/grayscale (NHWC uint8) → frame stacking →
reward-as-observation → space seeding → time limit → episode statistics.
The thunk pickles, so the ``async`` backend can send it to its worker.

``build_vector_env`` is the vector-env construction point of every
algorithm main: env ``i`` of process ``rank`` gets seed
``cfg.seed + rank * num_envs + i``, each env optionally wrapped in
``RestartOnException``, behind ``env.backend``:

- ``sync``: ``envs/vector.py::SyncVectorEnv`` (in-process),
- ``async``: ``envs/vector.py::AsyncVectorEnv`` (one spawned process per
  env),
- ``pool``: not ported (ROADMAP A10),

with ``env.sync_env`` kept as the deprecated alias (``backend`` null →
``sync`` when ``sync_env`` is true, else ``async``).

``env.wrapper._target_: gymnasium.make`` builds the port's own host env
for the ids it has (``envs/classic.py``: ``CartPole-v1`` and
``Pendulum-v1``, behind gymnasium's ``TimeLimit``), with vector
observations only.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item: ``gymnasium.make`` of any other id, pixels of the classic-control
envs, the game adapters (DMC, Atari, Crafter, MineRL, MineDojo, Diambra,
Mario), and video capture (``RecordVideo`` needs moviepy).
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.config.compose import instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.classic import CLASSIC_ENVS, make_classic_env
from sheeprl_tpu_torch.envs.dummy import get_dummy_env
from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv, SyncVectorEnv, VectorEnv
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    DictObservation,
    FrameStack,
    ImageTransform,
    MaskVelocityWrapper,
    RecordEpisodeStatistics,
    RenderObservation,
    RestartOnException,
    RewardAsObservationWrapper,
    TimeLimit,
)

__all__ = ["build_vector_env", "make_env", "get_dummy_env", "resolve_env_backend"]

_BACKENDS = ("sync", "async", "pool")

# env.wrapper targets of the JAX tree that the port does not build yet
_NOT_PORTED = {
    "gymnasium": "gymnasium's registry and its envs (ROADMAP A1: the port has no gymnasium; "
    "use env=pixel_pendulum, env=pixel_pointmass, env=pixel_catcher or env=dummy)",
    "sheeprl_tpu_torch.envs.dmc": "the DMC adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.dmc_variants": "the DMC adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.crafter": "the Crafter adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.minerl": "the MineRL adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.minedojo": "the MineDojo adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.diambra": "the Diambra adapter (ROADMAP A1)",
    "sheeprl_tpu_torch.envs.super_mario_bros": "the Super Mario Bros adapter (ROADMAP A1)",
}


def _check_ported(node: Any) -> None:
    """``NotImplementedError`` for a wrapper node (or a nested ``_target_``)
    the port cannot build, naming its ROADMAP item."""
    if isinstance(node, dict):
        target = str(node.get("_target_", ""))
        for prefix, what in _NOT_PORTED.items():
            if target == prefix or target.startswith(prefix + "."):
                raise NotImplementedError(f"env.wrapper._target_ {target!r}: {what} is not ported to sheeprl_tpu_torch yet")
        for v in node.values():
            _check_ported(v)


def resolve_env_backend(cfg: Dict[str, Any]) -> str:
    """``env.backend`` if set, else the ``env.sync_env`` deprecated alias."""
    backend = cfg["env"].get("backend", None)
    if backend in (None, "", "null"):
        return "sync" if bool(cfg["env"].get("sync_env", False)) else "async"
    backend = str(backend).lower()
    if backend not in _BACKENDS:
        raise ValueError(f"env.backend must be one of {_BACKENDS}, got {backend!r}")
    return backend


def build_vector_env(
    cfg: Dict[str, Any],
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "train",
    *,
    restart_on_exception: bool = False,
) -> VectorEnv:
    """The training vector env of one process: env ``i`` of ``rank`` gets
    seed ``cfg.seed + rank * num_envs + i`` and global slot ``i``,
    ``SAME_STEP`` autoreset; ``restart_on_exception`` wraps each env in
    :class:`RestartOnException` (the Dreamer family's default)."""
    num_envs = int(cfg["env"]["num_envs"])
    rank = int(rank)
    backend = resolve_env_backend(cfg)
    if backend == "pool":
        raise NotImplementedError(
            "env.backend=pool (the supervised shared-memory worker pool, sheeprl_tpu/rollout) is not ported to "
            "sheeprl_tpu_torch yet: ROADMAP A10; use env.backend=sync or async"
        )
    thunks = []
    for i in range(num_envs):
        thunk: Callable[[], Any] = make_env(cfg, int(cfg["seed"]) + rank * num_envs + i, rank * num_envs, run_name, prefix, vector_env_idx=i)
        if restart_on_exception:
            thunk = functools.partial(RestartOnException, thunk)
        thunks.append(thunk)
    return SyncVectorEnv(thunks) if backend == "sync" else AsyncVectorEnv(thunks)


def make_env(
    cfg: Dict[str, Any],
    seed: Optional[int],
    rank: int = 0,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], Any]:
    """A thunk creating a fully-wrapped env with a ``Dict`` observation
    space (JAX ``factory.py:115-223``)."""
    return functools.partial(_build_env, cfg, seed, rank, run_name, prefix, vector_env_idx)


def _build_env(cfg: Dict[str, Any], seed: Optional[int], rank: int, run_name: Optional[str], prefix: str, vector_env_idx: int) -> Any:
    env_cfg = cfg["env"]
    wrapper_cfg = env_cfg["wrapper"]
    classic = str(wrapper_cfg.get("_target_", "")) == "gymnasium.make"
    if classic:
        env_id = str(wrapper_cfg.get("id", env_cfg["id"]))
        if env_id not in CLASSIC_ENVS:
            raise NotImplementedError(
                f"env.wrapper._target_ 'gymnasium.make' with id {env_id!r}: gymnasium's registry is not ported to "
                f"sheeprl_tpu_torch (ROADMAP A1); the port's own host envs are {sorted(CLASSIC_ENVS)}"
            )
        if list(cfg["algo"]["cnn_keys"]["encoder"]):
            raise NotImplementedError(
                f"pixel observations of {env_id} (algo.cnn_keys.encoder): gymnasium renders it with pygame, which is "
                "not ported to sheeprl_tpu_torch yet (ROADMAP A1); use algo.cnn_keys.encoder=[]"
            )
    else:
        _check_ported(wrapper_cfg)
    if env_cfg.get("capture_video") and rank == 0 and vector_env_idx == 0 and run_name is not None:
        raise NotImplementedError(
            "env.capture_video=True: video capture (gymnasium's RecordVideo, which needs moviepy) is not ported to "
            "sheeprl_tpu_torch yet (ROADMAP A1); set env.capture_video=False"
        )
    instantiate_kwargs = {}
    if "seed" in wrapper_cfg:
        instantiate_kwargs["seed"] = seed
    if "rank" in wrapper_cfg:
        instantiate_kwargs["rank"] = rank + vector_env_idx
    if classic:
        env = make_classic_env(env_id, seed=seed)
    else:
        env = instantiate(wrapper_cfg, **instantiate_kwargs)

    if env_cfg["action_repeat"] > 1:
        env = ActionRepeat(env, env_cfg["action_repeat"])

    if env_cfg.get("mask_velocities", False):
        env = MaskVelocityWrapper(env)

    algo = cfg["algo"]
    raw_cnn, raw_mlp = algo["cnn_keys"]["encoder"], algo["mlp_keys"]["encoder"]
    if not isinstance(raw_cnn, (list, tuple)) or not isinstance(raw_mlp, (list, tuple)):
        raise ValueError(
            "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists of strings, "
            f"got cnn={raw_cnn!r} mlp={raw_mlp!r}"
        )
    cnn_keys, mlp_keys = list(raw_cnn), list(raw_mlp)
    if len(cnn_keys + mlp_keys) == 0:
        raise ValueError("at least one key must be set across `algo.cnn_keys.encoder` and `algo.mlp_keys.encoder`")

    # dict-ify the observation space (JAX factory.py:154-189)
    obs_space = env.observation_space
    if isinstance(obs_space, spaces.Box) and len(obs_space.shape) < 2:
        if len(cnn_keys) > 0:
            if len(cnn_keys) > 1:
                warnings.warn(
                    f"Multiple cnn keys specified but {env_cfg['id']} has a single pixel stream; keeping {cnn_keys[0]}"
                )
            env = RenderObservation(
                env,
                pixel_key=cnn_keys[0],
                pixels_only=len(mlp_keys) == 0,
                state_key=mlp_keys[0] if mlp_keys else "state",
            )
        else:
            if len(mlp_keys) > 1:
                warnings.warn(
                    f"Multiple mlp keys specified but {env_cfg['id']} has a single vector stream; keeping {mlp_keys[0]}"
                )
            env = DictObservation(env, mlp_keys[0])
    elif isinstance(obs_space, spaces.Box) and 2 <= len(obs_space.shape) <= 3:
        if len(cnn_keys) == 0:
            raise ValueError(
                "You have selected a pixel observation but no cnn key has been specified. "
                "Set at least one cnn key: `algo.cnn_keys.encoder=[your_cnn_key]`"
            )
        if len(cnn_keys) > 1:
            warnings.warn(f"Multiple cnn keys specified but {env_cfg['id']} has a single pixel stream; keeping {cnn_keys[0]}")
        env = DictObservation(env, cnn_keys[0])

    if len(set(env.observation_space.keys()).intersection(set(mlp_keys + cnn_keys))) == 0:
        raise ValueError(
            f"The user-specified keys {mlp_keys + cnn_keys} are not a subset of the environment "
            f"observation keys {list(env.observation_space.keys())}. Check your config."
        )

    # image standardization on the env's image-like keys we encode
    env_cnn_keys = {k for k in env.observation_space.spaces.keys() if len(env.observation_space[k].shape) in (2, 3)}
    used_cnn_keys = sorted(env_cnn_keys.intersection(cnn_keys))
    if used_cnn_keys:
        env = ImageTransform(env, used_cnn_keys, env_cfg["screen_size"], env_cfg["grayscale"])

    if used_cnn_keys and env_cfg["frame_stack"] > 1:
        env = FrameStack(env, env_cfg["frame_stack"], used_cnn_keys, env_cfg["frame_stack_dilation"])

    if env_cfg["reward_as_observation"]:
        env = RewardAsObservationWrapper(env)

    env.action_space.seed(seed)
    env.observation_space.seed(seed)
    if env_cfg["max_episode_steps"] and env_cfg["max_episode_steps"] > 0:
        env = TimeLimit(env, max_episode_steps=int(env_cfg["max_episode_steps"]))
    return RecordEpisodeStatistics(env)
