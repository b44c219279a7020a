"""PPO training (port of ``sheeprl_tpu/algos/ppo/ppo.py``: ``make_local_train``
:79-150, the fused-rollout gate :182-272 and ``main`` :275-881), on one
device.

The update is ``make_local_train``: ``update_epochs`` epochs, each a
permutation of the rollout cut into minibatches, each minibatch a forward,
the clipped PPO losses, a backward and an Adam step. With the critic on the
last observation and GAE in front (:func:`make_update_fn`), one update is
one ``ops/graph.py::CapturedStep``: one CUDA-graph replay on the card, its
epochs x minibatches steps recorded once. Each epoch's permutation is an
argsort of ``torch.rand`` from the train generator, which the graph
registers, so every replay draws fresh permutations. The clip and entropy
coefficients are a device tensor the loop fills before each replay
(``anneal_clip_coef``, ``anneal_ent_coef`` with ``polynomial_decay``), and
``anneal_lr``'s linear schedule is computed on the device from Adam's step
count, so a replay never bakes in a stale value.

``main`` collects a rollout on the host (``algo.fused_rollout=False``):
each step one policy call on the device and one copy of the env actions
back, the truncation bootstrap ``gamma * V(final_obs)`` for truncated envs,
and the step's values written into the ``RolloutStore`` on the device.
With ``algo.fused_rollout=True`` and an env that has a twin
(:func:`resolve_fused_rollout_spec`, the JAX gate; anything else takes the
host loop with a ``fused_fallback`` event), the rollout, GAE and the update
are one ``ops/rollout_scan.py`` superstep: one replay an update.

Checkpoints hold the JAX layout (``agent`` as the flax tree,
``opt_state`` in optax's nesting, ``update``, ``batch_size``,
``last_log``, ``last_checkpoint`` and the generators' states); a run
resumes from the port's or the JAX package's. NaN rollback, the crash
guard and the preemption exit are wired as in Dreamer-V3. A test episode
runs at the end (``algo.run_test``).

The loop itself is :func:`train_onpolicy`, which A2C (``algos/a2c``)
shares: an :class:`OnPolicyAlgorithm` names what the two differ in (the
update, its gradient steps, its metrics, the CNN keys, the truncation
bootstrap of the host loop).

Placement (JAX :339, :373-388): ``algo.player_device`` puts the player on
the host (its own copy of the agent, synced after each update as one flat
transfer) and ``algo.train_device`` the update (the agent, its optimizer
and the eager update; a CUDA graph only on the card), by
``parallel/fabric.py``'s resolvers; A2C reads both, through this loop.

``algo.overlap_collection`` (PPO only, JAX :693-865): the host loop
dispatches update N on a side stream and does not wait; rollout N+1 is
collected meanwhile by the player's snapshot of the params from before
update N (a copy of its own: the update writes the learner's in place),
into the other slot of a two-slot ``RolloutStore``. Before dispatching
N+1 the loop waits on N's metrics (``Time/train_wait_time``), checks them
(a non-finite update rolls back and the rollout collected against it is
dropped), and only then syncs the player. The last update is drained
before the final checkpoint and the test. The fused rollout turns it off.
``exp=ppo_decoupled`` raises naming ROADMAP A10.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.convert import optimizer_from_optax, optimizer_to_optax
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _clock, _elapsed, restore_generator, stream_seed
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, PPOPlayer, build_agent, evaluate_actions, rollout_step
from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax, agent_to_flax
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, prepare_obs, test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.jittable import get_jittable_env
from sheeprl_tpu_torch.envs.spaces import Box, action_dims
from sheeprl_tpu_torch.envs.variants import ScenarioFamily, compose_variant_env_id, make_scenario_family, sample_scenario_matrix
from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat
from sheeprl_tpu_torch.obs.telemetry import (
    get_telemetry,
    telemetry_advance,
    telemetry_mark_warm,
    telemetry_register_flops,
    telemetry_run_metrics,
    telemetry_train_window,
)
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.math import gae
from sheeprl_tpu_torch.ops.optim import Optimizer, build_optimizer
from sheeprl_tpu_torch.ops.rollout_scan import ENV_STREAM_SALT, init_env_carry, make_onpolicy_superstep_fn
from sheeprl_tpu_torch.ops.superstep import fused_fallback, reset_fused_fallback_warnings
from sheeprl_tpu_torch.parallel.fabric import Fabric, place_player, resolve_player_device, resolve_train_device
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.resilience.manager import RunResilience
from sheeprl_tpu_torch.utils.callback import CheckpointCallback
from sheeprl_tpu_torch.utils.checkpoint import elastic_per_rank_batch_size, load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.prealloc import RolloutBuffer, RolloutStore
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs

METRIC_ORDER = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")
ROLLOUT_KEYS = ("dones", "values", "actions", "logprobs", "rewards")


def make_local_train(
    agent: PPOAgent,
    opt: Optimizer,
    cfg: Mapping[str, Any],
    obs_keys: Sequence[str],
    n_local: int,
    generator: Optional[torch.Generator],
) -> Callable[..., torch.Tensor]:
    """The update over a flat ``[n_local, ...]`` rollout (JAX :79-150):
    ``local_train(data, coefs, perms=None) -> metrics [3]`` (the policy,
    value and entropy losses, averaged over epochs x minibatches), the
    agent and ``opt`` updated in place. ``coefs`` is ``[clip_coef,
    ent_coef]`` on the device. Each epoch draws its permutation as an
    argsort of ``torch.rand(n_local)`` from ``generator``; ``perms
    [epochs, n_local]`` replaces the draws (the parity tests pass the JAX
    permutations)."""
    algo = cfg["algo"]
    batch_size = int(algo["per_rank_batch_size"])
    update_epochs = int(algo["update_epochs"])
    num_minibatches = n_local // batch_size
    if num_minibatches == 0:
        raise ValueError(f"per_rank_batch_size ({batch_size}) is larger than the per-device rollout ({n_local})")
    dropped = n_local - num_minibatches * batch_size
    if dropped:
        warnings.warn(
            f"{dropped} of {n_local} rollout samples are dropped each epoch because per_rank_batch_size "
            f"({batch_size}) does not divide the rollout; choose rollout_steps*num_envs divisible by batch_size"
        )
    vf_coef = float(algo["vf_coef"])
    clip_vloss = bool(algo["clip_vloss"])
    normalize_adv = bool(algo["normalize_advantages"])
    reduction = str(algo["loss_reduction"])
    params = list(agent.parameters())
    used = num_minibatches * batch_size

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            new_logprobs, entropy, new_values = evaluate_actions(agent, {k: batch[k] for k in obs_keys}, batch["actions"])
            adv = batch["advantages"]
            if normalize_adv:
                adv = (adv - adv.mean()) / (adv.std() + 1e-8)
            pg = policy_loss(new_logprobs, batch["logprobs"], adv, clip_coef, reduction)
            v = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
            ent = entropy_loss(entropy, reduction)
            loss = pg + vf_coef * v + ent_coef * ent
            grads = torch.autograd.grad(loss, params)
        opt.step(grads)
        return torch.stack([pg, v, ent]).detach()

    def local_train(data: Dict[str, torch.Tensor], coefs: torch.Tensor, perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = coefs.device
        metrics = []
        for epoch in range(update_epochs):
            if perms is None:
                perm = torch.rand(n_local, generator=generator, device=dev).argsort()
            else:
                perm = perms[epoch].to(dev)
            perm = perm[:used].view(num_minibatches, batch_size)
            for i in range(num_minibatches):
                batch = {k: v.index_select(0, perm[i]) for k, v in data.items()}
                metrics.append(minibatch_step(batch, coefs[0], coefs[1]))
        return torch.stack(metrics).mean(0)

    return local_train


def make_update_fn(
    agent: PPOAgent,
    local_train: Callable[..., torch.Tensor],
    cfg: Mapping[str, Any],
    obs_keys: Sequence[str],
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """One update of the host loop over its static inputs: the rollout's
    ``[T, E, ...]`` tensors, ``next/<key>`` (the observation after the
    rollout) and ``coefs``: the critic on ``next``, GAE (JAX :797-808),
    the flattened rollout and ``local_train``. Returns the metrics."""
    gamma, lmbda = float(cfg["algo"]["gamma"]), float(cfg["algo"]["gae_lambda"])

    def update(inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            next_values = agent({k: inputs[f"next/{k}"] for k in obs_keys})[1]
            returns, advantages = gae(inputs["rewards"], inputs["values"], inputs["dones"], next_values, gamma, lmbda)
        data = {k: inputs[k] for k in (*obs_keys, *ROLLOUT_KEYS)}
        data["returns"], data["advantages"] = returns, advantages
        flat = {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]) for k, v in data.items()}
        return local_train(flat, inputs["coefs"])

    return update


def opt_state_tensors(agent: torch.nn.Module, opt: Optimizer) -> List[torch.Tensor]:
    """Every tensor an update writes in place."""
    return [*agent.parameters(), *opt.state_tensors()]


def collect_rollout(
    player: PPOPlayer,
    envs: Any,
    buf: RolloutBuffer,
    next_obs: Dict[str, np.ndarray],
    generator: Optional[torch.Generator],
    rollout_steps: int,
    gamma: float,
    cnn_keys: Sequence[str],
    on_episode: Optional[Callable[[int, float, int, int], None]] = None,
    bootstrap: bool = True,
) -> Dict[str, np.ndarray]:
    """The host loop's rollout (JAX :747-793): ``rollout_steps`` steps of
    the player on ``envs`` into ``buf``, the truncation bootstrap
    ``gamma * V(final_obs)`` on every truncated env unless ``bootstrap``
    is off (JAX A2C's host loop has none); returns the observation after
    the last step. ``on_episode(env, return, length, t)`` is called for
    each episode that ended at step ``t``."""
    agent = player.agent
    obs_keys = agent.cnn_keys + agent.mlp_keys
    num_envs = envs.num_envs
    act_shape = envs.single_action_space.shape
    for t in range(rollout_steps):
        actions, real_actions, logprobs, values = player.rollout_actions(next_obs, generator)
        real = real_actions.cpu().numpy()
        if not agent.is_continuous and len(agent.actions_dim) == 1:
            real = real[..., 0]
        obs, rewards, terminated, truncated, info = envs.step(real.reshape(num_envs, *act_shape))
        rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)
        truncated_envs = np.nonzero(truncated)[0]
        if bootstrap and len(truncated_envs) > 0 and "final_obs" in info:
            final = {k: np.stack([np.asarray(info["final_obs"][e][k]) for e in truncated_envs]) for k in obs_keys}
            final = prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(truncated_envs))
            vals = player.get_values(final).cpu().numpy().reshape(len(truncated_envs))
            rewards[truncated_envs, 0] += gamma * vals
        dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
        step_values: Dict[str, Any] = {k: next_obs[k] for k in obs_keys}
        step_values.update(dones=dones, values=values, actions=actions, logprobs=logprobs, rewards=rewards)
        buf.put(t, step_values)
        next_obs = prepare_obs(obs, cnn_keys=cnn_keys, num_envs=num_envs)
        if on_episode is not None and "final_info" in info:
            ep = info["final_info"].get("episode")
            if ep is not None:
                for i in np.nonzero(ep.get("_r", []))[0]:
                    on_episode(int(i), float(ep["r"][i]), int(ep["l"][i]), t)
    return next_obs


def scenario_variant_cfg(cfg: Mapping[str, Any]) -> Tuple[Tuple[str, ...], Dict[str, int], Dict[str, Tuple[float, float]], Optional[int]]:
    """The ``env.variants`` node: ``(names, family kwargs, ranges, seed)``
    (JAX :182-202)."""
    node = cfg["env"].get("variants", None)
    if not node:
        return (), {}, {}, None
    names = tuple(str(n) for n in (node.get("enabled", None) or ()))
    if not names:
        return (), {}, {}, None
    kwargs = {
        "distractor_dims": int(node.get("distractor_dims", 4)),
        "reward_max_delay": int(node.get("reward_max_delay", 4)),
    }
    ranges = {str(k): (float(v[0]), float(v[1])) for k, v in dict(node.get("ranges", None) or {}).items()}
    seed = node.get("seed", None)
    return names, kwargs, ranges, (None if seed is None else int(seed))


def resolve_fused_rollout_spec(
    cfg: Mapping[str, Any], cnn_keys: Sequence[str], mlp_keys: Sequence[str], observation_space: Any, is_continuous: bool, is_multidiscrete: bool, actions_dim: Sequence[int]
) -> Any:
    """The feasibility gate of ``algo.fused_rollout`` (JAX :222-272): the
    env's twin (a :class:`ScenarioFamily` with ``env.variants``) when the
    whole rollout can run on the device, else ``None`` after one
    ``fused_fallback`` event naming the gate."""
    env_id = str(cfg["env"]["id"])
    variant_names, family_kwargs, _, _ = scenario_variant_cfg(cfg)
    spec = get_jittable_env(env_id)
    if spec is None:
        missing = compose_variant_env_id(env_id, variant_names) if variant_names else env_id
        fused_fallback("jittable_env", f"no jittable twin registered for env id '{missing}'")
        return None
    if variant_names:
        spec = make_scenario_family(env_id, variant_names, **family_kwargs)
    if cnn_keys or len(mlp_keys) != 1:
        fused_fallback(
            "obs_keys", f"fused rollout needs exactly one MLP obs key and no CNN keys, got cnn={list(cnn_keys)} mlp={list(mlp_keys)}"
        )
        return None
    obs_shape = tuple(observation_space[mlp_keys[0]].shape)
    if obs_shape != (spec.obs_dim,):
        fused_fallback("obs_space", f"env obs {obs_shape} != jittable twin {(spec.obs_dim,)} — wrappers changed the observation")
        return None
    if is_multidiscrete or bool(is_continuous) != bool(spec.is_continuous) or tuple(actions_dim) != (spec.action_dim,):
        fused_fallback(
            "action_space",
            f"env actions {tuple(actions_dim)} (continuous={is_continuous}) != jittable twin "
            f"({spec.action_dim}, continuous={spec.is_continuous})",
        )
        return None
    if int(cfg["env"]["action_repeat"]) != 1:
        fused_fallback("action_repeat", "jittable twins model single-step dynamics only")
        return None
    return spec


class RunStart(NamedTuple):
    fabric: Fabric
    cfg: Dict[str, Any]
    state: Optional[Dict[str, Any]]
    log_dir: str
    logger: Any
    callback: CheckpointCallback
    resil: RunResilience


def start_run(fabric: Any, cfg: Optional[Dict[str, Any]], device: DeviceLike, vector_only: bool = False) -> RunStart:
    """The opening of PPO's, A2C's and recurrent PPO's ``main``: the
    Fabric (the CLI's, or one on ``device`` with a checkpoint callback when
    called as ``main(cfg, device=...)``), the
    CNN keys dropped with a warning when ``vector_only`` (A2C), the
    checkpoint to resume (``auto`` resolved) loaded, the log dir, logger
    and saved config, and the resilience plane over the callback."""
    ckpt_cfg = (cfg if isinstance(fabric, Fabric) else fabric)["checkpoint"]
    if not isinstance(fabric, Fabric):
        callback = CheckpointCallback(
            keep_last=ckpt_cfg["keep_last"], backend=ckpt_cfg["backend"], async_save=ckpt_cfg["async_save"]
        )
        fabric, cfg = Fabric.for_device(device, fabric["fabric"]["precision"], [callback]), fabric
    algo = cfg["algo"]
    if vector_only and algo["cnn_keys"]["encoder"]:
        warnings.warn(f"{algo['name']} is vector-only; the CNN keys will be ignored")
        algo["cnn_keys"]["encoder"] = []
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    log_dir = get_log_dir(cfg)
    logger = fabric.logger = get_logger(cfg, log_dir)
    logger.log_hyperparams(cfg)
    print(f"Log dir: {log_dir}")
    save_configs(cfg, log_dir)
    callback = next((cb for cb in fabric.callbacks if isinstance(cb, CheckpointCallback)), None)
    if callback is None:
        raise ValueError("fabric.callbacks holds no CheckpointCallback: the run could not save its checkpoints")
    return RunStart(fabric, cfg, state, log_dir, logger, callback, RunResilience(cfg, log_dir, callback))


@dataclass(frozen=True)
class OnPolicyAlgorithm:
    """What PPO's and A2C's loops differ in: ``make_local_train(agent, opt,
    cfg, obs_keys, n_local, generator) -> local_train(data, coefs)`` (the
    update over the flat rollout, returning ``metric_order``'s values),
    ``gradient_steps(cfg, n_local)`` (optimizer steps an update), the
    aggregator's keys, whether the agent reads vectors only (A2C drops the
    CNN keys with a warning), whether the host loop bootstraps truncated
    episodes and whether it reads ``algo.overlap_collection`` (PPO)."""

    make_local_train: Callable[..., Callable[..., torch.Tensor]]
    gradient_steps: Callable[[Mapping[str, Any], int], int]
    metric_order: Tuple[str, ...]
    aggregator_keys: FrozenSet[str]
    vector_only: bool = False
    bootstrap_truncated: bool = True
    overlap: bool = False


def _ppo_gradient_steps(cfg: Mapping[str, Any], n_local: int) -> int:
    algo = cfg["algo"]
    return int(algo["update_epochs"]) * max(1, n_local // int(algo["per_rank_batch_size"]))


PPO = OnPolicyAlgorithm(make_local_train, _ppo_gradient_steps, METRIC_ORDER, frozenset(AGGREGATOR_KEYS), overlap=True)


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None, record: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Train PPO, called as the CLI calls it, ``main(fabric, cfg)``, on the
    Fabric's device, or as ``main(cfg, device=...)`` on ``device`` (the CUDA
    card unless ``device="cpu"``), for ``algo.total_steps`` env steps (one
    update with ``dry_run``), as the JAX ``main`` runs it on one device.
    Returns the run's counts, seconds, metrics and graph replays. A
    ``record`` list receives, for each host-loop update, its inputs and the
    update's state before and after (:class:`_Recorder`)."""
    return train_onpolicy(fabric, cfg, device, PPO, record)


class _Recorder:
    """Each host-loop update's inputs, train-stream state and update state
    (params and optimizer) before, and its metrics and update state after,
    cloned on the stream that runs the update."""

    def __init__(self, out: List[Dict[str, Any]], tensors: Sequence[torch.Tensor], generator: torch.Generator) -> None:
        self.out, self.tensors, self.generator = out, list(tensors), generator
        self.current: Dict[str, Any] = {}

    def before(self, update: int, inputs: Mapping[str, torch.Tensor]) -> None:
        self.current = {
            "update": update,
            "inputs": {k: v.clone() for k, v in inputs.items()},
            "state_before": [t.detach().clone() for t in self.tensors],
            "generator": self.generator.get_state(),
        }

    def after(self, metrics: torch.Tensor) -> None:
        self.current.update(metrics=metrics.clone(), state_after=[t.detach().clone() for t in self.tensors])
        self.out.append(self.current)


def train_onpolicy(
    fabric: Any,
    cfg: Optional[Dict[str, Any]],
    device: DeviceLike,
    algorithm: OnPolicyAlgorithm,
    record: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The on-policy loop of PPO and A2C (``main``'s contract), with what
    differs taken from ``algorithm``."""
    fabric, cfg, state, log_dir, logger, callback, resil = start_run(fabric, cfg, device, algorithm.vector_only)
    ckpt_cfg = cfg["checkpoint"]
    run_dev = fabric.device
    algo = cfg["algo"]
    seed = int(cfg["seed"])

    envs = build_vector_env(cfg, 0, log_dir, "train")
    observation_space = envs.single_observation_space
    cnn_keys = list(algo["cnn_keys"]["encoder"])
    mlp_keys = list(algo["mlp_keys"]["encoder"])
    obs_keys = cnn_keys + mlp_keys
    if not obs_keys:
        raise RuntimeError(
            "You should specify at least one CNN key or MLP key from the cli: "
            "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`"
        )
    actions_dim, is_continuous = action_dims(envs.single_action_space)
    is_multidiscrete = not is_continuous and len(actions_dim) > 1

    # scenario variants run through the fused rollout only; `distractors`
    # widens the observation, so the agent is built against the family's
    names, family_kwargs, ranges, variant_seed = scenario_variant_cfg(cfg)
    family = make_scenario_family(str(cfg["env"]["id"]), names, **family_kwargs) if names else None
    obs_widened = False
    if family is not None and not cnn_keys and len(mlp_keys) == 1:
        if tuple(observation_space[mlp_keys[0]].shape) != (family.obs_dim,):
            spaces_d = dict(observation_space.spaces)
            spaces_d[mlp_keys[0]] = Box(-np.inf, np.inf, (family.obs_dim,), np.float32)
            observation_space = type(observation_space)(spaces_d)
            obs_widened = True

    agent, player = build_agent(
        actions_dim, is_continuous, cfg, observation_space, agent_from_flax(state["agent"]) if state else None, device=run_dev
    )
    # the update's device (JAX :373-388): the agent, its optimizer and every
    # tensor the update reads live there
    dev = resolve_train_device(algo.get("train_device", "auto"), agent, 1, run_dev) or run_dev
    if dev != run_dev:
        agent.to(dev)
        player = PPOPlayer(agent, dev)
    num_envs = int(cfg["env"]["num_envs"])
    rollout_steps = int(algo["rollout_steps"])
    policy_steps_per_update = num_envs * rollout_steps
    num_updates = int(algo["total_steps"]) // policy_steps_per_update if not cfg["dry_run"] else 1
    n_local = rollout_steps * num_envs
    batch_size = int(algo["per_rank_batch_size"])
    if state is not None:
        batch_size = elastic_per_rank_batch_size(int(state["batch_size"]), 1)
        algo["per_rank_batch_size"] = batch_size
    steps_per_update = algorithm.gradient_steps(cfg, n_local)
    max_grad_norm = float(algo["max_grad_norm"] or 0.0)
    opt = build_optimizer(
        list(agent.parameters()),
        algo["optimizer"],
        max_grad_norm,
        schedule_steps=num_updates * steps_per_update if algo.get("anneal_lr", False) else 0,
    )
    param_names = [n for n, _ in agent.named_parameters()]
    if state is not None:
        optimizer_from_optax(state["opt_state"], opt, param_names, agent_from_flax)
    if int(cfg["buffer"]["size"]) < rollout_steps:
        raise ValueError(f"The size of the buffer ({cfg['buffer']['size']}) cannot be lower than the rollout steps ({rollout_steps})")

    reset_fused_fallback_warnings()
    fused_spec = None
    if bool(algo.get("fused_rollout", False)):
        fused_spec = resolve_fused_rollout_spec(
            cfg, cnn_keys, mlp_keys, observation_space, is_continuous, is_multidiscrete, actions_dim
        )
    if family is not None and fused_spec is None:
        raise RuntimeError(
            "env.variants requires the fused rollout path; set algo.fused_rollout=True (if it is set, the "
            "fused_fallback telemetry event names the gate that failed)"
        )
    # the fused rollout has no host collection to overlap (JAX :433)
    overlap = algorithm.overlap and bool(algo.get("overlap_collection", False)) and fused_spec is None
    # the player's device (JAX :339); under overlap it acts on a snapshot
    # of its own, which the in-flight update does not write
    place_player(player, resolve_player_device(algo.get("player_device", "auto"), run_dev) or run_dev, snapshot=overlap)
    print(f"PPO-family placement: player on {player.device}, update on {dev}, overlap_collection={overlap}")

    # the train stream (permutations), the player stream and the env stream
    # of the fused rollout (JAX :464-480, :610)
    train_gen = torch.Generator(device=dev).manual_seed(seed)
    # the fused rollout's policy draws run in its graph on the update's device
    player_gen = torch.Generator(device=dev if fused_spec is not None else player.device).manual_seed(stream_seed(seed, 1))
    env_gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, ENV_STREAM_SALT))
    start_update = int(state["update"]) + 1 if state is not None else 1
    policy_step = int(state["update"]) * policy_steps_per_update if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    if state is not None:
        restore_generator(train_gen, state.get("rng_key"), seed, start_update - 1)
        restore_generator(player_gen, state.get("player_rng_key"), seed, start_update - 1, 1)

    local_train = algorithm.make_local_train(agent, opt, cfg, obs_keys, n_local, train_gen)
    # A2C has neither coefficient: its update reads no coefs
    initial_clip_coef, initial_ent_coef = float(algo.get("clip_coef", 0.0)), float(algo.get("ent_coef", 0.0))
    coefs = torch.tensor([initial_clip_coef, initial_ent_coef], device=dev)
    clip_coef, ent_coef = initial_clip_coef, initial_ent_coef
    metric_cfg = cfg["metric"]
    log_level, log_every = int(metric_cfg["log_level"]), int(metric_cfg["log_every"])
    aggregator = build_aggregator(cfg, algorithm.aggregator_keys)
    count_flops = get_telemetry() is not None
    gamma = float(algo["gamma"])

    # overlap on the card: each update runs on a stream of its own
    train_stream = torch.cuda.Stream(dev) if overlap and dev.type == "cuda" else None

    def settle() -> None:
        # reads of the learner's state after a dispatched update wait for it
        if train_stream is not None:
            torch.cuda.current_stream(dev).wait_stream(train_stream)

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        settle()
        return {
            "agent": agent_to_flax(agent.state_dict()),
            "opt_state": optimizer_to_optax(opt, param_names, agent_to_flax),
            "update": completed_update,
            "batch_size": batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": train_gen.get_state().numpy(),
            "player_rng_key": player_gen.get_state().numpy(),
        }

    def ckpt_path_fn(step: int) -> str:
        return os.path.join(log_dir, "checkpoint", f"ckpt_{step}_0.ckpt")

    @torch.no_grad()
    def rollback(at_update: int) -> None:
        # the params and the optimizer back to the newest committed
        # checkpoint, in place (a captured graph keeps reading them)
        nonlocal player_version
        restored = resil.rollback(update=at_update)
        sd = agent_from_flax(restored["agent"])
        for name, p in agent.named_parameters():
            p.copy_(sd[name])
        optimizer_from_optax(restored["opt_state"], opt, param_names, agent_from_flax)
        if "rng_key" in restored:
            restore_generator(train_gen, restored["rng_key"], seed, int(restored["update"]))
        resil.resalt_key(train_gen)
        player.sync_params()
        player_version = int(restored["update"])

    def on_episode(env: int, ret: float, length: int, t: int) -> None:
        # policy_step is the step count before the rollout
        if log_level > 0:
            aggregator.update("Rewards/rew_avg", ret)
            aggregator.update("Game/ep_len_avg", float(length))
            print(f"Rank-0: policy_step={policy_step + (t + 1) * num_envs}, reward_env_{env}={ret}")

    update_fn: Optional[CapturedStep] = None
    # two slots under overlap: rollout N+1 is written while update N copies
    # slot N into the graph's inputs on its stream (JAX :710)
    store = RolloutStore(rollout_steps, device=dev, slots=2 if overlap else 1)
    recorder = _Recorder(record, opt_state_tensors(agent, opt), train_gen) if record is not None else None
    next_obs: Dict[str, np.ndarray] = {}
    env_carry: Dict[str, torch.Tensor] = {}
    if fused_spec is not None:
        thetas = None
        if isinstance(fused_spec, ScenarioFamily):
            theta_gen = torch.Generator(device=dev).manual_seed(seed if variant_seed is None else variant_seed)
            thetas = sample_scenario_matrix(theta_gen, num_envs, fused_spec.variant_names, ranges)
        env_carry = init_env_carry(fused_spec, num_envs, env_gen, thetas)
        superstep = make_onpolicy_superstep_fn(
            fused_spec,
            policy_fn=lambda obs, g: rollout_step(agent, obs, g),
            value_fn=lambda obs: agent(obs)[1],
            local_train=local_train,
            obs_key=mlp_keys[0],
            rollout_steps=rollout_steps,
            gamma=gamma,
            gae_lambda=float(algo["gae_lambda"]),
            policy_generator=player_gen,
            env_generator=env_gen,
        )
        def fused_update(d: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
            # the graph's outputs are tensors: the episode stats as three
            metrics, stats = superstep({k: v for k, v in d.items() if k != "coefs"}, d["coefs"])
            return metrics, stats["done"], stats["ret"], stats["len"]

        inputs = {**env_carry, "coefs": coefs}
        update_fn = CapturedStep(
            fused_update,
            inputs,
            opt_state_tensors(agent, opt) + list(env_carry.values()),
            (player_gen, env_gen, train_gen),
        )
        update_fn.count_flops = count_flops
    else:
        obs, _ = envs.reset(seed=seed)
        next_obs = prepare_obs(obs, cnn_keys=cnn_keys, num_envs=num_envs)

    train_windows = last_train = 0
    metrics: Optional[torch.Tensor] = None
    preempted = False
    update = start_update
    windows: List[Tuple[Any, Any]] = []
    wall: List[float] = []  # host seconds of each update, rollout included
    env_seconds = 0.0
    # the completed updates in the params the player holds, by rollout
    player_version = start_update - 1
    collected_with: List[Tuple[int, int]] = []
    # overlap: (metrics, update, event) of the update in flight
    pending: Optional[Tuple[torch.Tensor, int, Any]] = None
    wait_seconds = 0.0

    def log_losses(metrics_np: np.ndarray) -> None:
        if log_level > 0:
            for name, value in zip(algorithm.metric_order, metrics_np):
                aggregator.update(name, float(value))

    def finalize_pending() -> bool:
        # the overlap loop's one wait (JAX :700-723): the in-flight update's
        # metrics, the finite check, and only then the player's params
        nonlocal pending, train_windows, player_version, wait_seconds
        if pending is None:
            return True
        pending_metrics, pending_update, event = pending
        pending = None
        t_wait = time.perf_counter()
        with timer("Time/train_wait_time"):
            if event is not None:
                event.synchronize()
            metrics_np = pending_metrics.cpu().numpy()
        wait_seconds += time.perf_counter() - t_wait
        train_windows += 1
        if resil.finite_checks and not resil.check_finite(metrics_np, pending_update):
            rollback(pending_update)
            return False
        player.sync_params()
        player_version = pending_update
        log_losses(metrics_np)
        return True

    def dispatch(update: int, buf: RolloutBuffer) -> torch.Tensor:
        # the slot, the observation after the rollout and the coefficients
        # into the graph's inputs, then the update, on the update's stream
        nonlocal update_fn
        if update_fn is None:
            inputs = {k: (v.clone() if overlap else v) for k, v in buf.arrays().items()}
            for k in obs_keys:
                inputs[f"next/{k}"] = torch.zeros_like(inputs[k][0])
            inputs["coefs"] = coefs
            update_fn = CapturedStep(make_update_fn(agent, local_train, cfg, obs_keys), inputs, opt_state_tensors(agent, opt), train_gen)
            update_fn.count_flops = count_flops
        stream = contextlib.nullcontext()
        if train_stream is not None:
            train_stream.wait_stream(torch.cuda.current_stream(dev))
            stream = torch.cuda.stream(train_stream)
        with stream:
            coefs.copy_(torch.tensor([clip_coef, ent_coef]), non_blocking=True)
            if overlap:
                for k, v in buf.arrays().items():
                    update_fn.inputs[k].copy_(v, non_blocking=True)
            for k in obs_keys:
                update_fn.inputs[f"next/{k}"].copy_(torch.from_numpy(next_obs[k]), non_blocking=True)
            if recorder is not None:
                recorder.before(update, update_fn.inputs)
            start = _clock(dev)
            out = update_fn()
            windows.append((start, _clock(dev)))
            if recorder is not None:
                recorder.after(out)
        return out

    resil.arm_crash_guard(path_fn=lambda: ckpt_path_fn(policy_step), state_fn=lambda: ckpt_state_fn(update - 1))
    t_start = time.perf_counter()
    try:
        for update in range(start_update, num_updates + 1):
            telemetry_advance(policy_step)
            if resil.preempt_requested():
                finalize_pending()
                last_checkpoint = policy_step
                resil.emergency_checkpoint(ckpt_path_fn(policy_step), ckpt_state_fn(update - 1))
                preempted = True
                break
            t_update = time.perf_counter()
            if fused_spec is not None:
                coefs.copy_(torch.tensor([clip_coef, ent_coef]), non_blocking=True)
                with timer("Time/env_interaction_time"):
                    start = _clock(dev)
                    metrics, ep_done, ep_ret, ep_len = update_fn()
                    windows.append((start, _clock(dev)))
                    metrics_np = metrics.cpu().numpy()
                telemetry_train_window(1, steps_per_update)
                if log_level > 0:
                    done = ep_done.cpu().numpy()
                    if done.any():
                        rets, lens = ep_ret.cpu().numpy(), ep_len.cpu().numpy()
                        for t, i in zip(*np.nonzero(done)):
                            on_episode(int(i), float(rets[t, i]), int(lens[t, i]), int(t))
                policy_step += policy_steps_per_update
            else:
                buf = store.begin(update)
                t_env = time.perf_counter()
                collected_with.append((update, player_version))
                with timer("Time/env_interaction_time"):
                    next_obs = collect_rollout(
                        player, envs, buf, next_obs, player_gen, rollout_steps, gamma, cnn_keys, on_episode, algorithm.bootstrap_truncated
                    )
                policy_step += policy_steps_per_update
                env_seconds += time.perf_counter() - t_env
                # T policy calls and copies, the critic, GAE and the update in one replay
                telemetry_train_window(rollout_steps + 1, steps_per_update)
                if overlap and not finalize_pending():
                    # the in-flight update rolled back: the rollout collected
                    # against it is dropped too (JAX :817-820)
                    wall.append(time.perf_counter() - t_update)
                    continue
                with timer("Time/train_time"):
                    metrics = dispatch(update, buf)
                    if not overlap:
                        metrics_np = metrics.cpu().numpy()
            wall.append(time.perf_counter() - t_update)
            if update == start_update:
                telemetry_register_flops(lambda: update_fn.flops, scale=1.0 / steps_per_update)
                telemetry_mark_warm()
            if overlap:
                # not waited on: the next rollout runs on the params from
                # before this update; the last one is drained before the
                # final checkpoint and the test
                pending = (metrics, update, None if train_stream is None else torch.cuda.Event())
                if train_stream is not None:
                    pending[2].record(train_stream)
                if update == num_updates:
                    finalize_pending()
            else:
                train_windows += 1
                if resil.finite_checks and not resil.check_finite(metrics_np, update):
                    rollback(update)
                    if fused_spec is not None:
                        # fresh episodes: poisoned params may have driven the env state non-finite too
                        for k, v in init_env_carry(fused_spec, num_envs, env_gen, env_carry.get("theta")).items():
                            update_fn.inputs[k].copy_(v)
                    continue
                player.sync_params()
                player_version = update
                log_losses(metrics_np)
            if log_level > 0 and (policy_step - last_log >= log_every or update == num_updates):
                metrics_dict = aggregator.compute()
                logger.log_metrics(metrics_dict, policy_step)
                telemetry_run_metrics(metrics_dict)
                aggregator.reset()
                log_sps_and_heartbeat(
                    logger,
                    policy_step=policy_step,
                    env_steps=(policy_step - last_log) * int(cfg["env"]["action_repeat"]),
                    train_steps=(train_windows - last_train) * steps_per_update,
                    train_invocations=train_windows - last_train,
                )
                last_log = policy_step
                last_train = train_windows
            # anneal the coefficients (JAX :548-558)
            if algo.get("anneal_clip_coef", False):
                clip_coef = polynomial_decay(update, initial=initial_clip_coef, final=0.0, max_decay_steps=num_updates, power=1.0)
            if algo.get("anneal_ent_coef", False):
                ent_coef = polynomial_decay(update, initial=initial_ent_coef, final=0.0, max_decay_steps=num_updates, power=1.0)
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                callback.on_checkpoint_coupled(ckpt_path_fn(policy_step), ckpt_state_fn(update))
        finalize_pending()
    except BaseException as err:
        if isinstance(err, Exception):
            resil.crash_checkpoint(err)
        resil.close()
        logger.finalize()
        envs.close()
        raise
    if dev.type == "cuda" or run_dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    envs.close()
    # the fused loop never played: the test plays the final params
    player.sync_params()
    test_reward, test_steps = None, 0
    if algo.get("run_test", True) and not preempted:
        if obs_widened:
            warnings.warn("skipping run_test: env.variants widened the observation past the host env's")
        else:
            test_reward, test_steps = test(player, cfg, log_dir, logger=logger)
    logger.finalize()
    resil.close()
    if preempted:
        resil.exit_preempted()
    window_seconds = [_elapsed(a, b) for a, b in windows]
    return {
        "log_dir": log_dir,
        "start_update": start_update,
        "updates": train_windows,
        "env_steps": policy_step,
        "gradient_steps": train_windows * steps_per_update,
        "seconds": seconds,
        "env_seconds": env_seconds,
        "update_seconds": window_seconds,
        "update_wall_seconds": wall,
        "metrics": {} if metrics is None else dict(zip(algorithm.metric_order, metrics.cpu().tolist())),
        "rollbacks": resil.rollbacks,
        "last_checkpoint": last_checkpoint,
        "fused_rollout": fused_spec is not None,
        "replays": 0 if update_fn is None else update_fn.replays,
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
        "player_device": str(player.device),
        "train_device": str(dev),
        "overlap_collection": overlap,
        # (update, completed updates in the params that collected its rollout)
        "collected_with": collected_with,
        # host seconds spent waiting on in-flight updates (Time/train_wait_time)
        "train_wait_seconds": wait_seconds,
    }
