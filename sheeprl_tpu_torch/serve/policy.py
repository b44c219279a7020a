"""Policy builders: checkpoint state -> a servable forward + obs spec (port of
``sheeprl_tpu/serve/policy.py``).

A builder takes the run config stored beside the checkpoint plus the loaded
state and returns a :class:`~sheeprl_tpu_torch.serve.model.ServedPolicy` —
``bind(params) -> forward``, the initial params, the per-request observation
spec and the ``params_from_state`` extractor hot swaps re-use. Registered
per algorithm name (the serve CLI dispatches on ``cfg.algo.name`` as eval
does); ``linear`` is the env-free synthetic policy the unit tests and drills
serve, so the robustness machinery is testable without a real checkpointed
run.

Serving is greedy and stateless: the PPO forward takes the distribution
mode, so identical observations yield identical actions across replicas —
which is what lets a crashed replica's re-queued request be re-served
anywhere.

A checkpoint's ``state["agent"]`` is the JAX package's flax param tree
(the port writes its checkpoints in the same layout), so a checkpoint
written by either package is servable.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.device import DeviceLike, Precision
from sheeprl_tpu_torch.serve.model import Params, ServedPolicy

POLICY_BUILDERS: Dict[str, Callable[..., ServedPolicy]] = {}


def register_policy_builder(*names: str) -> Callable:
    def deco(fn: Callable[..., ServedPolicy]) -> Callable[..., ServedPolicy]:
        for name in names:
            POLICY_BUILDERS[name] = fn
        return fn

    return deco


def serve_device(cfg: Any, device: DeviceLike = None) -> torch.device:
    """``device``, else the one ``fabric.accelerator`` names (``auto`` is the
    CUDA card, which raises without one: there is no CPU fallback)."""
    from sheeprl_tpu_torch.device import resolve_device
    from sheeprl_tpu_torch.parallel.fabric import accelerator_device

    if device is not None:
        return resolve_device(device)
    return accelerator_device(str((cfg.get("fabric") or {}).get("accelerator", "auto")))


def build_served_policy(cfg: Any, state: Dict[str, Any], device: DeviceLike = None) -> ServedPolicy:
    """Dispatch on ``cfg.algo.name``, on ``device`` (default: the one
    ``fabric.accelerator`` names). Unsupported algorithms fail with the
    list of servable ones, mirroring the eval registry's error shape."""
    name = cfg["algo"]["name"]
    builder = POLICY_BUILDERS.get(name)
    if builder is None:
        raise ValueError(
            f"no policy builder registered for algorithm '{name}'; "
            f"servable algorithms: {sorted(POLICY_BUILDERS)}"
        )
    return builder(cfg, state, serve_device(cfg, device))


@register_policy_builder("ppo", "ppo_decoupled")
def build_ppo_policy(cfg: Any, state: Dict[str, Any], device: DeviceLike = None) -> ServedPolicy:
    """Greedy PPO serving forward: ``obs -> env-ready actions`` (per-part
    int32 indices for discrete spaces, as JAX's ``argmax`` gives them; raw
    float32 vectors for continuous)."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent, real_actions_from_onehot, sample_actions
    from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import Dict as DictSpace
    from sheeprl_tpu_torch.envs.spaces import action_dims

    dev = serve_device(cfg, device)
    # spaces come from one throwaway env exactly like evaluate() builds them
    env = make_env(cfg, cfg["seed"], 0, None, "serve", vector_env_idx=0)()
    observation_space = env.observation_space
    action_space = env.action_space
    env.close()
    if not isinstance(observation_space, DictSpace):
        raise RuntimeError(f"unexpected observation space for serving: {observation_space}")
    actions_dim, is_continuous = action_dims(action_space)
    param_dtype = Precision(str(cfg["fabric"]["precision"])).param_dtype
    agent, _ = build_agent(actions_dim, is_continuous, cfg, observation_space, agent_from_flax(state["agent"]), device=dev)
    agent.eval()

    # per-request obs spec: the post-`prepare_obs` layout (frame stack folded
    # into channels, pixels uint8, vectors float32), WITHOUT the batch axis
    spec: Dict[str, Any] = {}
    for k in agent.cnn_keys:
        shape = tuple(observation_space[k].shape)
        if len(shape) == 4:  # [S,H,W,C] stacked -> [H,W,S*C]
            s, h, w, c = shape
            shape = (h, w, s * c)
        spec[k] = (shape, np.dtype(np.uint8))
    for k in agent.mlp_keys:
        spec[k] = (tuple(observation_space[k].shape), np.dtype(np.float32))

    def bind(params: Params) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
        # a module of its own a version, whose parameters ARE these tensors,
        # on their device (the card, or the CPU for a fleet's spill slot)
        module = copy.deepcopy(agent).to(next(iter(params.values())).device)
        module.load_state_dict(params, assign=True)

        def forward(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
            actions, _, _ = sample_actions(module, obs, greedy=True)
            real = real_actions_from_onehot(module.actions_dim, module.is_continuous, actions)
            return real if module.is_continuous else real.to(torch.int32)

        return forward

    def params_from_state(new_state: Dict[str, Any]) -> Params:
        # the converter a restore runs, then build_agent's placement and cast
        sd = agent_from_flax(new_state["agent"])
        return {k: v.to(device=dev, dtype=param_dtype if v.is_floating_point() else v.dtype) for k, v in sd.items()}

    return ServedPolicy(
        name=cfg["algo"]["name"],
        bind=bind,
        params={k: v.detach() for k, v in agent.state_dict().items()},
        obs_spec=spec,
        params_from_state=params_from_state,
        device=dev,
    )


@register_policy_builder("linear")
def build_linear_policy(cfg: Any, state: Dict[str, Any], device: DeviceLike = None) -> ServedPolicy:
    """Synthetic env-free policy for tests and serving drills: a single
    linear layer over a flat observation. State layout matches the real
    algos (``state["agent"]`` holds the params)."""
    dev = serve_device(cfg, device)

    def params_from_state(new_state: Dict[str, Any]) -> Params:
        return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in new_state["agent"].items()}

    def bind(params: Params) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
        w, b = params["w"], params["b"]
        return lambda obs: obs["vector"] @ w + b

    params = params_from_state(state)
    return ServedPolicy(
        name="linear",
        bind=bind,
        params=params,
        obs_spec={"vector": ((int(params["w"].shape[0]),), np.dtype(np.float32))},
        params_from_state=params_from_state,
        device=dev,
    )


def make_linear_state(in_dim: int = 4, out_dim: int = 2, seed: int = 0) -> Dict[str, Any]:
    """A deterministic ``state`` dict servable by the ``linear`` builder —
    what the tests checkpoint, commit and hot-swap."""
    rng = np.random.default_rng(seed)
    return {
        "agent": {
            "w": rng.standard_normal((in_dim, out_dim)).astype(np.float32),
            "b": rng.standard_normal((out_dim,)).astype(np.float32),
        },
        "update": 0,
    }
