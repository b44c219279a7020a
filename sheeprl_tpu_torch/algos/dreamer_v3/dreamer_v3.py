"""Dreamer-V3 training (port of ``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``:
``make_train_step`` :103-328, the target-critic EMA :573-575 and the loop of
``main`` :817-1060).

One gradient step is ``make_train_step``'s closure over the three models,
their optimizers and the target critic, on one process: the world-model
step through ``rssm_scan``, imagination over ``horizon + 1`` steps from
every posterior with the updated world model, the actor loss with the
Moments return normaliser, and the critic loss against the target critic.
With discrete actions no gradient reaches imagination (the advantage,
trajectories, actions and discount are all out of the actor's gradient), so
it runs under ``torch.no_grad``; with continuous actions the objective is
the advantage itself and the gradient flows back through every imagined
step, the fused RSSM step's backward included.

``main`` runs the JAX ``main`` on one accelerator as its defaults do (JAX
:462-540, :547-602, :742-835, :938-1140): env steps through ``PlayerDV3``
(random actions before ``learning_starts``), sequence replay where
``buffer.device`` puts it (the device ring, ``data/device_buffer.py``, or
the host buffer, memmapped with ``buffer.memmap``), ``Ratio``, and the train
window: with ``algo.fused_gradient_steps`` K = 0 one CUDA-graph replay of
the train step per gradient step (``ops/graph.py``), its batch gathered on
the card from the ring or copied by a pinned prefetcher from the host
buffer, the EMA between replays; with K > 0, ``ceil(G / K)`` replays of a
superstep graph of K steps (``ops/superstep.py``) that refreshes the target,
draws from the ring (or reads a stack drawn on the host) and trains. Then
metrics kept on the device until log time, a dispatch fence, checkpoints in
the JAX layout (the replay buffer too with ``buffer.checkpoint``), resume
(from a path or ``auto``, a checkpoint of either buffer mode into either),
NaN rollback, the crash guard and the preemption exit. ``main`` logs as the
JAX ``main`` does: the aggregated metrics through the run's logger
(``utils/logger.py``), the ``Time/env_interaction_time`` and
``Time/train_time`` spans (the train span closes after the card finished,
through the dispatch fence), and, with ``metric.telemetry.enabled``, the
telemetry hooks (``obs/``): the step, each train window's launches, the
FLOPs of one gradient step for MFU and a heartbeat a log window. Multiple
processes are not ported (ROADMAP queue A).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    Actor,
    Critic,
    WorldModel,
    actor_logprob_entropy,
    build_agent,
    build_critic,
    rssm_scan,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v3.convert import (
    actor_from_flax,
    actor_to_flax,
    adam_from_optax,
    adam_to_optax,
    critic_from_flax,
    critic_to_flax,
    world_model_from_flax,
    world_model_to_flax,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS, env_action, prepare_obs, test
from sheeprl_tpu_torch.data.device_buffer import (
    DeviceReplayBuffer,
    adapt_restored_buffer,
    draw_sequence_batch,
    make_sequential_replay,
)
from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import Box, action_dims
from sheeprl_tpu_torch.ops.distributions import (
    Bernoulli,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.ops.graph import WARMUP_STEPS, CapturedStep
from sheeprl_tpu_torch.ops.math import MomentsState, compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.ops.optim import Adam, adam
from sheeprl_tpu_torch.ops.superstep import SAMPLE_KEY_SALT, make_superstep_fn, periodic_target_ema, pregathered
from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat
from sheeprl_tpu_torch.obs.telemetry import (
    get_telemetry,
    telemetry_advance,
    telemetry_mark_warm,
    telemetry_register_flops,
    telemetry_run_metrics,
    telemetry_train_window,
)
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.parallel.fence import DispatchFence
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.resilience.manager import RunResilience
from sheeprl_tpu_torch.utils.callback import CheckpointCallback
from sheeprl_tpu_torch.utils.checkpoint import elastic_per_rank_batch_size, load_checkpoint, select_buffer
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, save_configs

METRIC_ORDER = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/policy_loss",
    "Loss/value_loss",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
)

TrainStep = Callable[..., Tuple[MomentsState, torch.Tensor]]


def _grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def make_train_step(
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    world_opt: Adam,
    actor_opt: Adam,
    critic_opt: Adam,
    cfg: Dict[str, Any],
    is_continuous: bool,
) -> TrainStep:
    """One gradient step over a time-major ``[T, B]`` batch.

    Returns ``train_step(moments, data, generator=None, grads_out=None) ->
    (moments, metrics)``: it updates the three models, their optimizers and
    ``moments`` in place (so a CUDA graph of the step reads and writes the
    same memory at every replay), returns ``moments`` and the 13 metrics of
    ``METRIC_ORDER`` as one device tensor (no host sync). ``data`` holds the
    obs keys, ``actions``, ``rewards``, ``terminated`` and ``is_first`` as
    ``[T, B, ...]`` tensors on the models' device; ``grads_out``, a dict, receives each model's
    gradients before clipping (``world_model``, ``actor``, ``critic``).
    """
    algo = cfg["algo"]
    wmc = algo["world_model"]
    cnn_keys = tuple(algo["cnn_keys"]["encoder"])
    mlp_keys = tuple(algo["mlp_keys"]["encoder"])
    cnn_dec_keys = tuple(algo["cnn_keys"]["decoder"])
    mlp_dec_keys = tuple(algo["mlp_keys"]["decoder"])
    horizon = int(algo["horizon"])
    gamma = float(algo["gamma"])
    lmbda = float(algo["lmbda"])
    ent_coef = float(algo["actor"]["ent_coef"])
    kl_args = (float(wmc["kl_dynamic"]), float(wmc["kl_representation"]))
    kl_args += (float(wmc["kl_free_nats"]), float(wmc["kl_regularizer"]))
    continue_scale = float(wmc["continue_scale_factor"])
    mcfg = algo["actor"]["moments"]
    moments_args = dict(
        decay=float(mcfg["decay"]),
        max_=float(mcfg["max"]),
        percentile_low=float(mcfg["percentile"]["low"]),
        percentile_high=float(mcfg["percentile"]["high"]),
    )
    wm_params = list(wm.parameters())
    actor_params = list(actor.parameters())
    critic_params = list(critic.parameters())

    def imagine(start_z: torch.Tensor, start_h: torch.Tensor, generator: Optional[torch.Generator]):
        """``horizon + 1`` latents from the start states, each with the
        action sampled at it (the last step's successor is not kept)."""
        z, h = start_z, start_h
        lat = torch.cat([z, h], -1)
        lats, acts = [], []
        for _ in range(horizon + 1):
            action = sample_actor_actions(actor, lat.detach(), generator)
            lats.append(lat)
            acts.append(action)
            z, h = wm.imagination(z, h, action, generator)
            lat = torch.cat([z, h], -1)
        return torch.stack(lats), torch.stack(acts)

    def train_step(
        moments: MomentsState,
        data: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        grads_out: Optional[Dict[str, List[torch.Tensor]]] = None,
    ) -> Tuple[MomentsState, torch.Tensor]:
        T, B = data["rewards"].shape[:2]
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        # a_t in the RSSM input is the action that led to o_t
        batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
        batch_obs = {k: data[k] for k in cnn_keys + mlp_keys}
        obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_dec_keys}
        obs_targets.update({k: data[k].float() for k in mlp_dec_keys})

        # ---------------- world model ---------------- #
        embedded = wm.encode(batch_obs)
        hs, zs, post_logits, prior_logits = rssm_scan(wm, embedded, batch_actions, is_first, generator)
        latents = torch.cat([zs, hs], -1)
        recon = wm.decode(latents)
        po: Dict[str, Any] = {k: MSEDistribution(recon[k], dims=3) for k in cnn_dec_keys}
        po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_dec_keys})
        pr = TwoHotEncodingDistribution(wm.reward_logits(latents), dims=1)
        pc = Independent(Bernoulli(wm.continue_logits(latents)), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po,
            obs_targets,
            pr,
            data["rewards"],
            prior_logits,
            post_logits,
            *kl_args,
            pc,
            1 - data["terminated"],
            continue_scale,
        )
        wm_grads = _grads(rec_loss, wm_params)
        wm_gnorm = world_opt.step(wm_grads)

        # ---------------- behaviour (imagination reads the updated model) ---------------- #
        start_z = zs.detach().reshape(T * B, -1)
        start_h = hs.detach().reshape(T * B, -1)
        true_continue = (1 - data["terminated"]).reshape(T * B, 1)
        with torch.set_grad_enabled(is_continuous):
            trajectories, imagined_actions = imagine(start_z, start_h, generator)
            values = TwoHotEncodingDistribution(critic(trajectories), dims=1).mean
            rewards = TwoHotEncodingDistribution(wm.reward_logits(trajectories), dims=1).mean
            continues = Independent(Bernoulli(wm.continue_logits(trajectories)), 1).mode
            continues = torch.cat([true_continue[None], continues[1:]], 0)
            lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * gamma, lmbda)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
        new_moments, (offset, invscale) = update_moments(moments, lambda_values, **moments_args)
        moments.low.copy_(new_moments.low)
        moments.high.copy_(new_moments.high)
        baseline = values[:-1]
        advantage = (lambda_values - offset) / invscale - (baseline - offset) / invscale
        logp, entropy = actor_logprob_entropy(actor, trajectories.detach(), imagined_actions.detach())
        if is_continuous:
            objective = advantage
        else:
            objective = logp[..., None][:-1] * advantage.detach()
        policy_loss = -torch.mean(discount[:-1] * (objective + ent_coef * entropy[..., None][:-1]))
        actor_grads = _grads(policy_loss, actor_params)
        actor_gnorm = actor_opt.step(actor_grads)

        # ---------------- critic ---------------- #
        traj_in = trajectories[:-1].detach()
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(traj_in), dims=1).mean
        qv = TwoHotEncodingDistribution(critic(traj_in), dims=1)
        value_loss = -qv.log_prob(lambda_values.detach()) - qv.log_prob(target_values)
        value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
        critic_grads = _grads(value_loss, critic_params)
        critic_gnorm = critic_opt.step(critic_grads)

        with torch.no_grad():
            post_ent = Independent(OneHotCategorical(post_logits), 1).entropy().mean()
            prior_ent = Independent(OneHotCategorical(prior_logits), 1).entropy().mean()
            metrics = torch.stack(
                [
                    rec_loss,
                    observation_loss,
                    reward_loss,
                    state_loss,
                    continue_loss,
                    kl,
                    post_ent,
                    prior_ent,
                    policy_loss,
                    value_loss,
                    wm_gnorm,
                    actor_gnorm,
                    critic_gnorm,
                ]
            ).detach()
        if grads_out is not None:
            grads_out.update(world_model=wm_grads, actor=actor_grads, critic=critic_grads)
        return moments, metrics

    return train_step


def make_train_fn(
    train_step: TrainStep,
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    opts: Sequence[Adam],
    moments: MomentsState,
    inputs: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
) -> CapturedStep:
    """``train_step`` over the static batch ``inputs`` as a
    ``CapturedStep`` (JAX ``make_train_fn`` :331-366): replayed from one
    CUDA graph on the card, eager on the CPU; it updates the three models,
    their optimizers and ``moments`` in place and draws from ``generator``."""
    state = [*wm.parameters(), *actor.parameters(), *critic.parameters()]
    for opt in opts:
        state += [*opt.mu, *opt.nu, opt.count]
    return CapturedStep(
        lambda data: train_step(moments, data, generator)[1], inputs, state + [moments.low, moments.high], generator
    )


def make_fused_train_fn(
    train_step: TrainStep,
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    opts: Sequence[Adam],
    moments: MomentsState,
    cfg: Dict[str, Any],
    gather: Callable[[Any, int], Dict[str, torch.Tensor]],
    num_steps: int,
    stack: Optional[Dict[str, torch.Tensor]],
    generators: Sequence[torch.Generator],
) -> CapturedStep:
    """``num_steps`` gradient steps, each the target refresh, ``gather``'s
    batch and ``train_step``, as one ``CapturedStep`` (JAX
    ``make_fused_train_fn`` :368-460). Its inputs are ``counter`` (the
    run's gradient steps before the call, which the caller sets) and the
    ``[K, T, B, ...]`` ``stack`` that ``gather`` reads when the batches are
    drawn on the host (``None`` when ``gather`` draws from the ring). A call
    returns ``(metrics [K, 13], finite [K])``; the first of ``generators``
    is the train stream."""
    critic_cfg = cfg["algo"]["critic"]
    freq = max(1, int(critic_cfg["per_rank_target_network_update_freq"]))
    tau = float(critic_cfg["tau"])
    source, target = list(critic.parameters()), list(target_critic.parameters())
    params = [*wm.parameters(), *actor.parameters(), *source, *target]
    superstep = make_superstep_fn(
        lambda batch: train_step(moments, batch, generators[0])[1],
        gather,
        num_steps,
        pre_step=lambda counter: periodic_target_ema(counter, source, target, freq, tau),
        params=params,
    )
    state = list(params)
    for opt in opts:
        state += [*opt.mu, *opt.nu, opt.count]
    inputs = {"counter": torch.zeros((), dtype=torch.int64, device=moments.low.device), **(stack or {})}
    return CapturedStep(
        lambda d: superstep(d["counter"], {k: v for k, v in d.items() if k != "counter"}),
        inputs,
        state + [moments.low, moments.high],
        generators,
        # a call is num_steps steps: fewer calls warm the step up
        warmup=-(-WARMUP_STEPS // num_steps),
    )


@torch.no_grad()
def ema_(critic: Critic, target_critic: Critic, tau: float) -> None:
    """``target = tau * critic + (1 - tau) * target``, in place."""
    target = list(target_critic.parameters())
    torch._foreach_mul_(target, 1 - tau)
    torch._foreach_add_(target, torch._foreach_mul(list(critic.parameters()), tau))


def build_optimizers(cfg: Dict[str, Any], wm: WorldModel, actor: Actor, critic: Critic) -> Tuple[Adam, Adam, Adam]:
    """The world-model, actor and critic optimizers of ``cfg``."""
    algo = cfg["algo"]
    return tuple(
        adam(list(m.parameters()), algo[k]["optimizer"], algo[k]["clip_gradients"])
        for m, k in ((wm, "world_model"), (actor, "actor"), (critic, "critic"))
    )


def random_actions(rng: np.random.Generator, action_space: Any, actions_dim: Sequence[int], n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(player_actions [n, A], env_actions)`` drawn uniformly: one-hots
    for a discrete space, a uniform draw in a bounded Box and a standard
    normal one in an unbounded Box."""
    if isinstance(action_space, Box):
        low, high = action_space.low, action_space.high
        bounded = np.isfinite(low) & np.isfinite(high)
        a = np.where(
            bounded,
            rng.uniform(np.where(bounded, low, 0), np.where(bounded, high, 1), (n, *action_space.shape)),
            rng.standard_normal((n, *action_space.shape)),
        ).astype(np.float32)
        return a, a
    idx = rng.integers(0, actions_dim[0], n)
    return np.eye(actions_dim[0], dtype=np.float32)[idx], idx


def to_batch(sample: Dict[str, np.ndarray], cnn_keys: Sequence[str], device: torch.device) -> Dict[str, torch.Tensor]:
    """One ``[T, B, ...]`` train batch from a replay sample's first draw:
    pixels stay uint8 across the bus, everything else goes fp32."""
    return {
        k: torch.as_tensor(v[0] if k in cnn_keys else v[0].astype(np.float32)).to(device) for k, v in sample.items()
    }


def batch_inputs(
    rb: Any,
    sequence_length: int,
    batch_size: int,
    cnn_keys: Sequence[str],
    device: torch.device,
    stack: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Static ``[T, B, ...]`` input tensors (``[stack, T, B, ...]`` with
    ``stack``) for the keys of ``rb``, a host buffer or the device ring:
    pixels uint8, everything else fp32."""
    stored = rb.bufs if isinstance(rb, DeviceReplayBuffer) else rb.buffer[0].buffer
    lead = (sequence_length, batch_size) if stack is None else (stack, sequence_length, batch_size)
    return {
        k: torch.zeros((*lead, *v.shape[2:]), dtype=torch.uint8 if k in cnn_keys else torch.float32, device=device)
        for k, v in stored.items()
    }


def stream_seed(*parts: int) -> int:
    """A 63-bit seed for one random stream, derived from ``parts``."""
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _names(module: torch.nn.Module) -> List[str]:
    return [n for n, _ in module.named_parameters()]


def checkpoint_state(
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    opts: Sequence[Adam],
    moments: MomentsState,
) -> Dict[str, Any]:
    """The models, optimizers and Moments in the JAX checkpoint layout
    (``ckpt_state_fn``, JAX :742-763): flax-named numpy param trees, each
    optimizer state in optax's chain nesting, ``moments`` as 0-d arrays."""
    world_opt, actor_opt, critic_opt = opts
    return {
        "world_model": world_model_to_flax(wm.state_dict()),
        "actor": actor_to_flax(actor.state_dict()),
        "critic": critic_to_flax(critic.state_dict()),
        "target_critic": critic_to_flax(target_critic.state_dict()),
        "world_optimizer": adam_to_optax(world_opt, _names(wm), world_model_to_flax),
        "actor_optimizer": adam_to_optax(actor_opt, _names(actor), actor_to_flax),
        "critic_optimizer": adam_to_optax(critic_opt, _names(critic), critic_to_flax),
        "moments": {k: np.array(getattr(moments, k).item(), dtype=np.float32) for k in ("low", "high")},
    }


@torch.no_grad()
def load_checkpoint_state(
    state: Mapping[str, Any],
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    opts: Sequence[Adam],
    moments: MomentsState,
) -> None:
    """:func:`checkpoint_state` back into the live modules, optimizers and
    Moments, in place (a captured train step keeps reading the same
    tensors). Takes the port's checkpoints and the JAX package's."""
    wm.load_state_dict(world_model_from_flax(state["world_model"]))
    actor.load_state_dict(actor_from_flax(state["actor"]))
    critic.load_state_dict(critic_from_flax(state["critic"]))
    target_critic.load_state_dict(critic_from_flax(state["target_critic"]))
    for opt, key, module, convert in zip(
        opts,
        ("world_optimizer", "actor_optimizer", "critic_optimizer"),
        (wm, actor, critic),
        (world_model_from_flax, actor_from_flax, critic_from_flax),
    ):
        adam_from_optax(state[key], opt, _names(module), convert)
    moments.low.fill_(float(np.asarray(state["moments"]["low"])))
    moments.high.fill_(float(np.asarray(state["moments"]["high"])))


def restore_generator(generator: torch.Generator, saved: Any, seed: int, update: int, *salt: int) -> None:
    """Set ``generator`` to a state the port saved; a JAX threefry key
    (anything else) cannot continue in torch, so the stream is seeded from
    ``(seed, update, *salt)`` instead, with a warning."""
    arr = np.asarray(saved)
    if arr.dtype == np.uint8 and arr.shape == tuple(generator.get_state().shape):
        generator.set_state(torch.from_numpy(arr.copy()))
        return
    warnings.warn(
        f"the checkpoint's RNG key (shape {arr.shape}, {arr.dtype}) is not a torch generator state: "
        f"seeding the stream from (seed={seed}, update={update}) instead"
    )
    generator.manual_seed(stream_seed(seed, update, *salt))


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train Dreamer-V3, called as the CLI calls it, ``main(fabric, cfg)``,
    on the Fabric's device, or as ``main(cfg, device=...)`` on ``device``
    (the CUDA card unless ``device="cpu"``), for ``algo.total_steps`` env
    steps, as the JAX
    ``main`` runs it on one accelerator: the player acts on the vector env
    of ``build_vector_env`` (``env.backend``, each env restarted on an
    exception, the last stored step of a restarted env amended to a
    truncation), with uniform random actions up to ``algo.learning_starts``
    on a fresh run; every step goes
    into sequence replay (the device ring or the host buffer, by
    ``buffer.device``), ``Ratio`` sets each update's gradient steps, and
    each gradient step is one replay of the captured train step (eagerly on
    the CPU) with the target-critic EMA between replays, or, with
    ``algo.fused_gradient_steps`` K > 0, each K steps one replay of a
    captured superstep. Metric vectors stay on the device until log time.
    Checkpoints go to ``<log dir>/checkpoint`` on the ``checkpoint.every``
    cadence and at the end (``save_last``); ``checkpoint.resume_from`` (a
    path, or ``auto``) resumes from the port's checkpoints or the JAX
    package's; non-finite metrics roll back to the newest committed
    checkpoint; SIGTERM writes an emergency checkpoint and exits with
    ``PREEMPTED_EXIT_CODE``. With ``algo.run_test``, one test episode follows
    training. Returns the run's counts, seconds and metrics."""
    ckpt_cfg = (cfg if isinstance(fabric, Fabric) else fabric)["checkpoint"]
    if not isinstance(fabric, Fabric):
        callback = CheckpointCallback(
            keep_last=ckpt_cfg["keep_last"], backend=ckpt_cfg["backend"], async_save=ckpt_cfg["async_save"]
        )
        fabric, cfg = Fabric.for_device(device, fabric["fabric"]["precision"], [callback]), fabric
    dev = fabric.device
    algo = cfg["algo"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    # these arguments cannot be changed (JAX :466-467)
    cfg["env"]["frame_stack"] = 1
    screen = int(cfg["env"]["screen_size"])
    if 2 ** int(np.log2(screen)) != screen:
        raise ValueError(f"The screen size must be a power of 2, got: {screen}")
    num_envs = int(cfg["env"]["num_envs"])
    log_dir = get_log_dir(cfg)
    logger = fabric.logger = get_logger(cfg, log_dir)
    logger.log_hyperparams(cfg)
    print(f"Log dir: {log_dir}")
    save_configs(cfg, log_dir)
    callback = next((cb for cb in fabric.callbacks if isinstance(cb, CheckpointCallback)), None)
    if callback is None:
        raise ValueError("fabric.callbacks holds no CheckpointCallback: the run could not save its checkpoints")
    resil = RunResilience(cfg, log_dir, callback)
    envs = build_vector_env(cfg, 0, log_dir, "train", restart_on_exception=True)
    action_space = envs.single_action_space
    obs_space = envs.single_observation_space
    actions_dim, is_continuous = action_dims(action_space)
    cnn_keys = list(algo["cnn_keys"]["encoder"])
    mlp_keys = list(algo["mlp_keys"]["encoder"])
    obs_keys = cnn_keys + mlp_keys
    clip_rewards = bool(cfg["env"].get("clip_rewards", False))

    wm, actor, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    critic, target_critic = build_critic(cfg, wm.latent_state_size, device=dev)
    opts = build_optimizers(cfg, wm, actor, critic)
    moments = init_moments(dev)
    if state is not None:
        load_checkpoint_state(state, wm, actor, critic, target_critic, opts, moments)
    train_step = make_train_step(wm, actor, critic, target_critic, *opts, cfg, is_continuous)

    dry_run = bool(cfg.get("dry_run", False))
    buffer_cfg = cfg["buffer"]
    buffer_size = int(buffer_cfg["size"]) // num_envs if not dry_run else 2
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    rb = make_sequential_replay(cfg, dev, obs_space, actions_dim, buffer_size, num_envs, obs_keys, memmap_dir, seed)
    use_device_rb = isinstance(rb, DeviceReplayBuffer)
    if state is not None and buffer_cfg["checkpoint"]:
        # a checkpoint of either buffer mode resumes into this run's mode
        rb = adapt_restored_buffer(
            select_buffer(state["rb"], 0, 1),
            use_device_rb,
            seed=seed,
            memmap=bool(buffer_cfg["memmap"]),
            memmap_dir=memmap_dir,
            device=dev,
        )

    # counters (JAX :584-602)
    start_step = int(state["update"]) + 1 if state is not None else 1
    policy_step = int(state["update"]) * num_envs if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    num_updates = int(algo["total_steps"]) // num_envs if not dry_run else 1
    learning_starts = int(algo["learning_starts"]) // num_envs if not dry_run else 0
    batch_size = int(algo["per_rank_batch_size"])
    sequence_length = int(algo["per_rank_sequence_length"])
    ratio = Ratio(float(algo["replay_ratio"]), pretrain_steps=int(algo["per_rank_pretrain_steps"]))
    if state is not None:
        batch_size = elastic_per_rank_batch_size(int(state["batch_size"]), 1)
        if not buffer_cfg["checkpoint"]:
            learning_starts += start_step
        ratio.load_state_dict(state["ratio"])
    critic_cfg = algo["critic"]
    ema_every = int(critic_cfg["per_rank_target_network_update_freq"])
    fused_k = int(algo.get("fused_gradient_steps", 0) or 0)

    # the train stream, the player stream (JAX :722-736) and the stream of
    # the in-graph replay draw of a fused superstep
    train_gen = torch.Generator(device=dev).manual_seed(seed)
    player_gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    sample_gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, SAMPLE_KEY_SALT))
    if state is not None:
        update0 = int(state["update"])
        restore_generator(train_gen, state["rng_key"], seed, update0)
        restore_generator(player_gen, state["player_rng_key"], seed, update0, 1)
        if "sample_rng_key" in state:
            restore_generator(sample_gen, state["sample_rng_key"], seed, update0, SAMPLE_KEY_SALT)
    action_rng = np.random.default_rng(seed)

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(wm, actor, critic, target_critic, opts, moments),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": train_gen.get_state().numpy(),
            "player_rng_key": player_gen.get_state().numpy(),
            "sample_rng_key": sample_gen.get_state().numpy(),
        }

    def ckpt_path_fn(step: int) -> str:
        return os.path.join(log_dir, "checkpoint", f"ckpt_{step}_0.ckpt")

    def buffer_to_save() -> Any:
        return rb if buffer_cfg["checkpoint"] else None

    def nan_rollback(at_update: int) -> None:
        # the train state (params, target, optimizers, Moments, Ratio, the
        # train stream) back to the newest committed checkpoint, in place;
        # the replay buffer holds observations only and stays
        restored = resil.rollback(update=at_update)
        load_checkpoint_state(restored, wm, actor, critic, target_critic, opts, moments)
        ratio.load_state_dict(restored["ratio"])
        if "rng_key" in restored:
            restore_generator(train_gen, restored["rng_key"], seed, int(restored["update"]))
        if "sample_rng_key" in restored:
            restore_generator(sample_gen, restored["sample_rng_key"], seed, int(restored["update"]), SAMPLE_KEY_SALT)
        resil.resalt_key(train_gen)
        resil.resalt_key(sample_gen)
        pending.clear()  # the poisoned window must not reach the log

    step_data: Dict[str, np.ndarray] = {}
    obs, _ = envs.reset(seed=seed)
    stacked = {k: obs[k] for k in obs_keys}
    # MineDojo's action masks ride the observation (JAX :847-849)
    masks = {k: obs[k] for k in obs if k.startswith("mask")}
    prepared = prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs)
    for k in obs_keys:
        step_data[k] = prepared[k][np.newaxis]
    zeros = np.zeros((1, num_envs, 1), np.float32)
    step_data.update(rewards=zeros.copy(), truncated=zeros.copy(), terminated=zeros.copy(), is_first=np.ones_like(zeros))
    player.init_states()

    train_fn: Optional[CapturedStep] = None
    prefetcher: Optional[BatchPrefetcher] = None
    # one superstep graph per distinct chunk length, and for the host buffer
    # the prefetcher of its [n, T, B, ...] stacks
    fused_fns: Dict[int, CapturedStep] = {}
    fused_feeds: Dict[int, BatchPrefetcher] = {}

    def get_fused_fn(n: int) -> CapturedStep:
        fn = fused_fns.get(n)
        if fn is None:
            if use_device_rb:
                # the ring's static tensors: the graph reads them in place
                bufs, pos, full = rb.superstep_inputs(sequence_length)
                gather = lambda ctx, i: draw_sequence_batch(bufs, pos, full, sample_gen, batch_size, sequence_length)  # noqa: E731
                stack, gens = None, (train_gen, sample_gen)
            else:
                gather, gens = pregathered, (train_gen,)
                stack = batch_inputs(rb, sequence_length, batch_size, cnn_keys, dev, stack=n)
            fn = fused_fns[n] = make_fused_train_fn(
                train_step, wm, actor, critic, target_critic, opts, moments, cfg, gather, n, stack, gens
            )
            fn.count_flops = count_flops
            if len(fused_fns) == 1:
                # a replay runs n gradient steps
                telemetry_register_flops(lambda: fn.flops, scale=1.0 / n)
            if stack is not None:
                # the stacks drawn by the buffer's own generator, as the
                # per-step path draws its batches
                depth = int(buffer_cfg["prefetch"])
                fused_feeds[n] = BatchPrefetcher(rb, batch_size, sequence_length, stack, depth, fn.done, n_samples=n)
        return fn

    def superstep_window(n_steps: int) -> List[torch.Tensor]:
        """The train window as ceil(n_steps / K) superstep replays, K steps
        each and the remainder last (JAX :938-1000); returns their [chunk]
        finite vectors."""
        nonlocal gradient_steps, metrics
        finite = []
        for n, count in ((fused_k, n_steps // fused_k), (n_steps % fused_k, int(n_steps % fused_k > 0))):
            if count == 0:
                continue
            fn = get_fused_fn(n)
            feeds = itertools.repeat(None, count) if use_device_rb else fused_feeds[n].sampled_batches(count)
            for _ in feeds:
                if use_device_rb:
                    rb.superstep_inputs(sequence_length)
                fn.inputs["counter"].fill_(gradient_steps)
                block, chunk_finite = fn()
                gradient_steps += n
                finite.append(chunk_finite)
                metrics = block[-1]
                if log_level > 0:
                    pending.append(block)
        return finite

    fence = DispatchFence(dev, depth=int(algo.get("dispatch_fence_depth", 4) or 4))
    metric_cfg = cfg["metric"]
    log_level, log_every = int(metric_cfg["log_level"]), int(metric_cfg["log_every"])
    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS)
    action_repeat = int(cfg["env"].get("action_repeat", 1) or 1)
    count_flops = get_telemetry() is not None
    train_windows = last_train = last_grad_steps = 0
    pending: List[torch.Tensor] = []  # device metric vectors, fetched at log time
    logged: List[Tuple[int, Dict[str, float]]] = []
    windows: List[Tuple[Any, Any]] = []  # each train window's (start, end) events or clock times
    gradient_steps = 0
    metrics: Optional[torch.Tensor] = None
    preempted = False
    update = start_step
    resil.arm_crash_guard(
        path_fn=lambda: ckpt_path_fn(policy_step),
        state_fn=lambda: ckpt_state_fn(update - 1),
        replay_buffer_fn=buffer_to_save,
    )
    t_start = time.perf_counter()
    try:
        for update in range(start_step, num_updates + 1):
            telemetry_advance(policy_step)
            if resil.preempt_requested():
                fence.drain()
                last_checkpoint = policy_step
                resil.emergency_checkpoint(ckpt_path_fn(policy_step), ckpt_state_fn(update - 1), buffer_to_save())
                preempted = True
                break
            policy_step += num_envs
            with timer("Time/env_interaction_time"):
                if update <= learning_starts and state is None:
                    actions, real_actions = random_actions(action_rng, action_space, actions_dim, num_envs)
                else:
                    actions = player.get_actions(
                        prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs), player_gen, mask=masks or None
                    )
                    real_actions = [env_action(a, actions_dim, is_continuous) for a in actions]
                step_data["actions"] = np.asarray(actions, np.float32).reshape(1, num_envs, -1)
                rb.add(step_data)

                next_obs, rewards, terminated, truncated, infos = envs.step(
                    np.asarray(real_actions).reshape(num_envs, *action_space.shape)
                )
                dones = np.logical_or(terminated, truncated)

            step_data["is_first"] = np.zeros((1, num_envs, 1), np.float32)
            if "restart_on_exception" in infos:
                for i, roe in enumerate(np.asarray(infos["restart_on_exception"]).reshape(-1)):
                    if roe and not dones[i]:
                        # the last stored step becomes a truncation and the
                        # episode restarts (JAX :869-882)
                        if use_device_rb:
                            rb.amend_last(i, terminated=0.0, truncated=1.0, is_first=0.0)
                        else:
                            sub = rb.buffer[i]
                            last_idx = (sub._pos - 1) % sub.buffer_size
                            sub["terminated"][last_idx] = 0.0
                            sub["truncated"][last_idx] = 1.0
                            sub["is_first"][last_idx] = 0.0
                        step_data["is_first"][0, i] = 1.0

            if log_level > 0 and "final_info" in infos:
                ep = infos["final_info"].get("episode")
                if ep is not None:
                    for i in np.nonzero(ep.get("_r", []))[0]:
                        aggregator.update("Rewards/rew_avg", float(ep["r"][i]))
                        aggregator.update("Game/ep_len_avg", float(ep["l"][i]))

            stacked = {k: next_obs[k] for k in obs_keys}
            masks = {k: next_obs[k] for k in next_obs if k.startswith("mask")}
            prepared = prepare_obs(stacked, cnn_keys=cnn_keys, num_envs=num_envs)
            for k in obs_keys:
                step_data[k] = prepared[k][np.newaxis]
            rewards = np.asarray(rewards, np.float32).reshape(1, num_envs, 1)
            step_data["rewards"] = np.tanh(rewards) if clip_rewards else rewards
            step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, num_envs, 1)
            step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, num_envs, 1)

            dones_idxes = dones.nonzero()[0].tolist()
            if dones_idxes:
                # the terminal transition with the true final obs (SAME_STEP
                # autoreset keeps it in infos) and a zero action, then the
                # per-env episode state restarts
                final = {k: np.stack([infos["final_obs"][i][k] for i in dones_idxes]) for k in obs_keys}
                prepared_final = prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(dones_idxes))
                reset_data = {k: prepared_final[k][np.newaxis] for k in obs_keys}
                for k in ("terminated", "truncated", "rewards"):
                    reset_data[k] = step_data[k][:, dones_idxes]
                reset_data["actions"] = np.zeros((1, len(dones_idxes), int(sum(actions_dim))), np.float32)
                reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
                rb.add(reset_data, dones_idxes)
                for k in ("rewards", "terminated", "truncated"):
                    step_data[k][:, dones_idxes] = 0.0
                step_data["is_first"][:, dones_idxes] = 1.0
                player.init_states(dones_idxes)

            # ---------------- training ---------------- #
            if update >= learning_starts:
                n_steps = ratio(policy_step)
                if n_steps > 0 and fused_k > 0:
                    with timer("Time/train_time"):
                        start = _clock(dev)
                        replays_before = sum(fn.replays for fn in fused_fns.values())
                        finite = superstep_window(n_steps)
                        windows.append((start, _clock(dev)))
                        fence.push()
                        if not timer.disabled:
                            # the span ends when the card has finished the window
                            fence.drain()
                    train_windows += 1
                    telemetry_train_window(sum(fn.replays for fn in fused_fns.values()) - replays_before, n_steps)
                    # the first window captured the step: a later capture is a recompile
                    telemetry_mark_warm()
                    # one fetch a window: the finite vectors the supersteps
                    # computed in their graphs
                    if resil.finite_checks and not resil.window_ok(bool(torch.cat(finite).all()), update):
                        nan_rollback(update)
                        continue
                elif n_steps > 0:
                    if train_fn is None:
                        inputs = batch_inputs(rb, sequence_length, batch_size, cnn_keys, dev)
                        train_fn = make_train_fn(train_step, wm, actor, critic, opts, moments, inputs, train_gen)
                        train_fn.count_flops = count_flops
                        if not use_device_rb:
                            prefetcher = BatchPrefetcher(
                                rb, batch_size, sequence_length, inputs, int(buffer_cfg["prefetch"]), train_fn.done
                            )
                    with timer("Time/train_time"):
                        start = _clock(dev)
                        if use_device_rb:
                            # each batch gathered on the card into the step's inputs,
                            # after the replay before it on the same stream
                            batches = rb.sample_batches(batch_size, sequence_length, n_steps, out=train_fn.inputs)
                        else:
                            batches = prefetcher.sampled_batches(n_steps)
                        emas = 0
                        for _ in batches:
                            if gradient_steps % ema_every == 0:
                                ema_(critic, target_critic, 1.0 if gradient_steps == 0 else float(critic_cfg["tau"]))
                                emas += 1
                            metrics = train_fn()
                            gradient_steps += 1
                            if gradient_steps == 1:
                                telemetry_register_flops(lambda: train_fn.flops)
                            if log_level > 0:
                                pending.append(metrics)
                        windows.append((start, _clock(dev)))
                        fence.push()
                        if not timer.disabled:
                            # the span ends when the card has finished the window
                            fence.drain()
                    train_windows += 1
                    # a replay a step, the ring's gather a step, the target refreshes
                    telemetry_train_window(n_steps * (2 if use_device_rb else 1) + emas, n_steps)
                    telemetry_mark_warm()
                    # the window's last metric vector: a NaN in the params
                    # reaches every later loss (JAX :1047-1055)
                    if resil.finite_checks and not resil.check_finite(metrics.cpu().numpy(), update):
                        nan_rollback(update)
                        continue

            # ---------------- logging ---------------- #
            if log_level > 0 and (policy_step - last_log >= log_every or update == num_updates):
                if pending:
                    # per-step vectors and superstep blocks, in one copy
                    rows = torch.cat([m.reshape(-1, len(METRIC_ORDER)) for m in pending])
                    for row in rows.cpu().numpy():
                        for name, value in zip(METRIC_ORDER, row):
                            aggregator.update(name, value)
                    pending.clear()
                metrics_dict = aggregator.compute()
                logger.log_metrics(metrics_dict, policy_step)
                telemetry_run_metrics(metrics_dict)
                logged.append((policy_step, metrics_dict))
                aggregator.reset()
                if policy_step > 0:
                    logger.log_metrics({"Params/replay_ratio": gradient_steps / policy_step}, policy_step)
                log_sps_and_heartbeat(
                    logger,
                    policy_step=policy_step,
                    env_steps=(policy_step - last_log) * action_repeat,
                    train_steps=train_windows - last_train,
                    train_invocations=gradient_steps - last_grad_steps,
                )
                last_log = policy_step
                last_train = train_windows
                last_grad_steps = gradient_steps

            # ---------------- checkpoint ---------------- #
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                callback.on_checkpoint_coupled(ckpt_path_fn(policy_step), ckpt_state_fn(update), buffer_to_save())
    except BaseException as err:
        if isinstance(err, Exception):
            resil.crash_checkpoint(err)
        resil.close()
        logger.finalize()
        envs.close()
        raise
    fence.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t_start
    envs.close()
    test_reward, test_steps = None, 0
    if algo.get("run_test", False) and not preempted:
        test_reward, test_steps = test(player, cfg, log_dir, greedy=False, logger=logger)
    logger.finalize()
    resil.close()
    if preempted:
        resil.exit_preempted()
    last = {} if metrics is None else dict(zip(METRIC_ORDER, metrics.cpu().tolist()))
    # (steps a replay, captured graph) of the run: the per-step graph, or
    # the superstep graphs by chunk length
    graphs = sorted(fused_fns.items()) if fused_k > 0 else ([(1, train_fn)] if train_fn is not None else [])
    window_seconds = [_elapsed(a, b) for a, b in windows]
    return {
        "log_dir": log_dir,
        "start_update": start_step,
        "env_steps": policy_step,
        "gradient_steps": gradient_steps,
        "seconds": seconds,
        "train_seconds": sum(window_seconds),
        "train_window_seconds": window_seconds,
        "metrics": last,
        "log": logged,
        "moments": (float(moments.low), float(moments.high)),
        "rollbacks": resil.rollbacks,
        "last_checkpoint": last_checkpoint,
        # fused_gru launches of the replayed steps: the captured calls a
        # replay relaunches, and the replays
        "captured_launches_per_step": graphs[0][1].captured_launches // graphs[0][0] if graphs else 0,
        "replays": sum(fn.replays for _, fn in graphs),
        "graphs": [{"steps": n, "captured_launches": fn.captured_launches, "replays": fn.replays} for n, fn in graphs],
        "replay_buffer": "device" if use_device_rb else ("memmap" if all(rb.is_memmap) else "host"),
        # the episode played after training (algo.run_test), on the player
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }


def _clock(dev: torch.device) -> Any:
    """A point in time: a recorded CUDA event on the card, else the host's
    clock."""
    if dev.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(dev))
    return event


def _elapsed(start: Any, end: Any) -> float:
    """Seconds between two :func:`_clock` points (the events completed)."""
    return start.elapsed_time(end) / 1e3 if isinstance(start, torch.cuda.Event) else end - start
