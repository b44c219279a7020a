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
processes are not ported (ROADMAP queue A). The loop's parts, ``EnvLoop``,
``loop_state``, ``ReplayTrainer`` (the per-step train window) and
``LogWindows``, also run the P2E mains.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

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
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
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
from sheeprl_tpu_torch.parallel.fabric import Fabric, place_player, resolve_player_device
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


def train_hparams(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The hyperparameters of one Dreamer-V3 gradient step, read once from
    ``cfg``: the encoder and decoder keys, the imagination horizon, the
    lambda-return's ``gamma`` and ``lmbda``, the actor's entropy coefficient,
    the KL terms, the continue scale and the Moments' arguments."""
    algo = cfg["algo"]
    wmc = algo["world_model"]
    mcfg = algo["actor"]["moments"]
    return dict(
        cnn_keys=tuple(algo["cnn_keys"]["encoder"]),
        mlp_keys=tuple(algo["mlp_keys"]["encoder"]),
        cnn_dec_keys=tuple(algo["cnn_keys"]["decoder"]),
        mlp_dec_keys=tuple(algo["mlp_keys"]["decoder"]),
        horizon=int(algo["horizon"]),
        gamma=float(algo["gamma"]),
        lmbda=float(algo["lmbda"]),
        ent_coef=float(algo["actor"]["ent_coef"]),
        kl_args=(
            float(wmc["kl_dynamic"]),
            float(wmc["kl_representation"]),
            float(wmc["kl_free_nats"]),
            float(wmc["kl_regularizer"]),
        ),
        continue_scale=float(wmc["continue_scale_factor"]),
        moments_args=dict(
            decay=float(mcfg["decay"]),
            max_=float(mcfg["max"]),
            percentile_low=float(mcfg["percentile"]["low"]),
            percentile_high=float(mcfg["percentile"]["high"]),
        ),
    )


def world_model_step(
    wm: WorldModel,
    world_opt: Adam,
    data: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    hp: Dict[str, Any],
    detach_heads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
    """The world-model loss over a ``[T, B]`` batch and its Adam step.
    ``detach_heads`` feeds the reward and continue heads detached latents
    (Plan2Explore). Returns ``(hs, zs, metrics, gnorm, grads)``: the
    posterior scan's states, the eight world-model metrics of
    ``METRIC_ORDER`` and the gradients before clipping."""
    is_first = data["is_first"].clone()
    is_first[0] = 1.0
    # a_t in the RSSM input is the action that led to o_t
    batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
    batch_obs = {k: data[k] for k in hp["cnn_keys"] + hp["mlp_keys"]}
    obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in hp["cnn_dec_keys"]}
    obs_targets.update({k: data[k].float() for k in hp["mlp_dec_keys"]})

    embedded = wm.encode(batch_obs)
    hs, zs, post_logits, prior_logits = rssm_scan(wm, embedded, batch_actions, is_first, generator)
    latents = torch.cat([zs, hs], -1)
    recon = wm.decode(latents)
    po: Dict[str, Any] = {k: MSEDistribution(recon[k], dims=3) for k in hp["cnn_dec_keys"]}
    po.update({k: SymlogDistribution(recon[k], dims=1) for k in hp["mlp_dec_keys"]})
    head_in = latents.detach() if detach_heads else latents
    pr = TwoHotEncodingDistribution(wm.reward_logits(head_in), dims=1)
    pc = Independent(Bernoulli(wm.continue_logits(head_in)), 1)
    rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        po,
        obs_targets,
        pr,
        data["rewards"],
        prior_logits,
        post_logits,
        *hp["kl_args"],
        pc,
        1 - data["terminated"],
        hp["continue_scale"],
    )
    grads = _grads(rec_loss, list(wm.parameters()))
    gnorm = world_opt.step(grads)
    with torch.no_grad():
        post_ent = Independent(OneHotCategorical(post_logits), 1).entropy().mean()
        prior_ent = Independent(OneHotCategorical(prior_logits), 1).entropy().mean()
    metrics = [rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent, prior_ent]
    return hs, zs, metrics, gnorm, grads


def imagine(
    wm: WorldModel,
    actor: Actor,
    start_z: torch.Tensor,
    start_h: torch.Tensor,
    horizon: int,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``horizon + 1`` latents from the start states, each with the action
    ``actor`` sampled at it (the last step's successor is not kept)."""
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


def policy_loss(
    actor: Actor,
    trajectories: torch.Tensor,
    imagined_actions: torch.Tensor,
    advantage: torch.Tensor,
    discount: torch.Tensor,
    ent_coef: float,
    is_continuous: bool,
) -> torch.Tensor:
    """The actor's objective over an imagination: the advantage itself with
    continuous actions (its gradient runs back through imagination), the
    log-probability times the detached advantage with discrete ones, plus
    the entropy bonus, discounted."""
    logp, entropy = actor_logprob_entropy(actor, trajectories.detach(), imagined_actions.detach())
    objective = advantage if is_continuous else logp[..., None][:-1] * advantage.detach()
    return -torch.mean(discount[:-1] * (objective + ent_coef * entropy[..., None][:-1]))


def critic_loss(critic: Critic, target_critic: Critic, traj_in: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The two-hot critic's loss on the detached imagination ``traj_in``
    against the lambda-returns and the target critic's values."""
    with torch.no_grad():
        target_values = TwoHotEncodingDistribution(target_critic(traj_in), dims=1).mean
    qv = TwoHotEncodingDistribution(critic(traj_in), dims=1)
    value_loss = -qv.log_prob(lambda_values.detach()) - qv.log_prob(target_values)
    return torch.mean(value_loss * discount[:-1].squeeze(-1))


def behaviour_step(
    wm: WorldModel,
    actor: Actor,
    critic: Critic,
    target_critic: Critic,
    actor_opt: Adam,
    critic_opt: Adam,
    moments: MomentsState,
    start: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    generator: Optional[torch.Generator],
    hp: Dict[str, Any],
    is_continuous: bool,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The actor and critic updates over one imagination from ``start`` =
    ``(z, h, true_continue)`` with the (updated) world model, the Moments
    normalising the lambda-returns in place. Returns ``([policy_loss,
    value_loss], [actor_gnorm, critic_gnorm], [actor_grads, critic_grads])``."""
    start_z, start_h, true_continue = start
    gamma = hp["gamma"]
    with torch.set_grad_enabled(is_continuous):
        trajectories, imagined_actions = imagine(wm, actor, start_z, start_h, hp["horizon"], generator)
        values = TwoHotEncodingDistribution(critic(trajectories), dims=1).mean
        rewards = TwoHotEncodingDistribution(wm.reward_logits(trajectories), dims=1).mean
        continues = Independent(Bernoulli(wm.continue_logits(trajectories)), 1).mode
        continues = torch.cat([true_continue[None], continues[1:]], 0)
        lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * gamma, hp["lmbda"])
        discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
    new_moments, (offset, invscale) = update_moments(moments, lambda_values, **hp["moments_args"])
    moments.low.copy_(new_moments.low)
    moments.high.copy_(new_moments.high)
    advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
    loss = policy_loss(actor, trajectories, imagined_actions, advantage, discount, hp["ent_coef"], is_continuous)
    actor_grads = _grads(loss, list(actor.parameters()))
    actor_gnorm = actor_opt.step(actor_grads)

    value_loss = critic_loss(critic, target_critic, trajectories[:-1].detach(), lambda_values, discount)
    critic_grads = _grads(value_loss, list(critic.parameters()))
    critic_gnorm = critic_opt.step(critic_grads)
    return [loss, value_loss], [actor_gnorm, critic_gnorm], [actor_grads, critic_grads]


def imagination_start(zs: torch.Tensor, hs: torch.Tensor, terminated: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every posterior of the batch as an imagination start, detached:
    ``(z [T*B, S], h [T*B, H], true_continue [T*B, 1])``."""
    n = zs.shape[0] * zs.shape[1]
    return zs.detach().reshape(n, -1), hs.detach().reshape(n, -1), (1 - terminated).reshape(n, 1)


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
    hp = train_hparams(cfg)

    def train_step(
        moments: MomentsState,
        data: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        grads_out: Optional[Dict[str, List[torch.Tensor]]] = None,
    ) -> Tuple[MomentsState, torch.Tensor]:
        hs, zs, wm_metrics, wm_gnorm, wm_grads = world_model_step(wm, world_opt, data, generator, hp)
        # behaviour: imagination reads the updated world model
        start = imagination_start(zs, hs, data["terminated"])
        losses, gnorms, (actor_grads, critic_grads) = behaviour_step(
            wm, actor, critic, target_critic, actor_opt, critic_opt, moments, start, generator, hp, is_continuous
        )
        metrics = torch.stack([*wm_metrics, *losses, wm_gnorm, *gnorms]).detach()
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
    ``stack``) for the keys of ``rb``, a host buffer, the device ring or an
    ``EpisodeBuffer`` (by its first episode): pixels uint8, everything else
    fp32."""
    if isinstance(rb, EpisodeBuffer):
        trailing = {k: v.shape[1:] for k, v in rb.buffer[0].items()}
    else:
        stored = rb.bufs if isinstance(rb, DeviceReplayBuffer) else rb.buffer[0].buffer
        trailing = {k: v.shape[2:] for k, v in stored.items()}
    lead = (sequence_length, batch_size) if stack is None else (stack, sequence_length, batch_size)
    return {
        k: torch.zeros((*lead, *shape), dtype=torch.uint8 if k in cnn_keys else torch.float32, device=device)
        for k, shape in trailing.items()
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


def resolve_fabric(fabric: Any, cfg: Optional[Dict[str, Any]], device: DeviceLike) -> Tuple[Fabric, Dict[str, Any], CheckpointCallback]:
    """``(fabric, cfg, checkpoint callback)`` of a Dreamer-family ``main``
    called as the CLI calls it, ``main(fabric, cfg)``, or as ``main(cfg,
    device=...)``: a one-device Fabric on ``device`` (the CUDA card unless
    ``device="cpu"``) at the config's precision, with a
    ``CheckpointCallback`` of the config's ``checkpoint`` node."""
    if not isinstance(fabric, Fabric):
        ckpt_cfg = fabric["checkpoint"]
        callback = CheckpointCallback(
            keep_last=ckpt_cfg["keep_last"], backend=ckpt_cfg["backend"], async_save=ckpt_cfg["async_save"]
        )
        fabric, cfg = Fabric.for_device(device, fabric["fabric"]["precision"], [callback]), fabric
    callback = next((cb for cb in fabric.callbacks if isinstance(cb, CheckpointCallback)), None)
    if callback is None:
        raise ValueError("fabric.callbacks holds no CheckpointCallback: the run could not save its checkpoints")
    return fabric, cfg, callback


class EnvLoop:
    """The env side of the Dreamer-family loop (JAX ``dreamer_v3.py``
    :847-935; the P2E mains repeat it): each ``step`` takes one action per
    env (uniform random ones, or the player's on the prepared
    observations), stores the step in ``rb``, steps the vector env, amends
    the last stored step of an env restarted after an exception to a
    truncation, feeds finished episodes to ``aggregator``, stores each done
    env's terminal transition (the true final observation and a zero
    action) and restarts its player state."""

    def __init__(
        self,
        envs: Any,
        rb: Any,
        player: Any,
        cfg: Dict[str, Any],
        aggregator: Any,
        player_gen: torch.Generator,
        action_rng: np.random.Generator,
    ) -> None:
        self.envs, self.rb, self.player, self.aggregator = envs, rb, player, aggregator
        self.player_gen, self.action_rng = player_gen, action_rng
        self.action_space = envs.single_action_space
        self.actions_dim, self.is_continuous = action_dims(self.action_space)
        self.num_envs = int(cfg["env"]["num_envs"])
        self.cnn_keys = list(cfg["algo"]["cnn_keys"]["encoder"])
        self.obs_keys = self.cnn_keys + list(cfg["algo"]["mlp_keys"]["encoder"])
        self.clip_rewards = bool(cfg["env"].get("clip_rewards", False))
        self.log_level = int(cfg["metric"]["log_level"])
        self.validate_args = bool(cfg["buffer"].get("validate_args", False))
        self.step_data: Dict[str, np.ndarray] = {}
        self.stacked: Dict[str, np.ndarray] = {}
        self.masks: Dict[str, np.ndarray] = {}

    def _observe(self, obs: Dict[str, np.ndarray]) -> None:
        self.stacked = {k: obs[k] for k in self.obs_keys}
        # MineDojo's action masks ride the observation (JAX :847-849)
        self.masks = {k: obs[k] for k in obs if k.startswith("mask")}
        prepared = prepare_obs(self.stacked, cnn_keys=self.cnn_keys, num_envs=self.num_envs)
        for k in self.obs_keys:
            self.step_data[k] = prepared[k][np.newaxis]

    def reset(self, seed: int) -> None:
        """Reset the envs and the player's states."""
        obs, _ = self.envs.reset(seed=seed)
        self._observe(obs)
        zeros = np.zeros((1, self.num_envs, 1), np.float32)
        self.step_data.update(rewards=zeros.copy(), truncated=zeros.copy(), terminated=zeros.copy(), is_first=np.ones_like(zeros))
        self.player.init_states()

    def step(self, random: bool) -> None:
        """One env step of every env; ``random`` takes uniform actions."""
        n, step_data, rb = self.num_envs, self.step_data, self.rb
        with timer("Time/env_interaction_time"):
            if random:
                actions, real_actions = random_actions(self.action_rng, self.action_space, self.actions_dim, n)
            else:
                prepared = prepare_obs(self.stacked, cnn_keys=self.cnn_keys, num_envs=n)
                actions = self.player.get_actions(prepared, self.player_gen, mask=self.masks or None)
                real_actions = [env_action(a, self.actions_dim, self.is_continuous) for a in actions]
            step_data["actions"] = np.asarray(actions, np.float32).reshape(1, n, -1)
            rb.add(step_data, validate_args=self.validate_args)

            next_obs, rewards, terminated, truncated, infos = self.envs.step(
                np.asarray(real_actions).reshape(n, *self.action_space.shape)
            )
            dones = np.logical_or(terminated, truncated)

        step_data["is_first"] = np.zeros((1, n, 1), np.float32)
        if "restart_on_exception" in infos:
            for i, roe in enumerate(np.asarray(infos["restart_on_exception"]).reshape(-1)):
                if roe and not dones[i]:
                    # the last stored step becomes a truncation and the
                    # episode restarts (JAX :869-882)
                    if isinstance(rb, DeviceReplayBuffer):
                        rb.amend_last(i, terminated=0.0, truncated=1.0, is_first=0.0)
                    else:
                        sub = rb.buffer[i]
                        last_idx = (sub._pos - 1) % sub.buffer_size
                        sub["terminated"][last_idx] = 0.0
                        sub["truncated"][last_idx] = 1.0
                        sub["is_first"][last_idx] = 0.0
                    step_data["is_first"][0, i] = 1.0

        if self.log_level > 0 and "final_info" in infos:
            ep = infos["final_info"].get("episode")
            if ep is not None:
                for i in np.nonzero(ep.get("_r", []))[0]:
                    self.aggregator.update("Rewards/rew_avg", float(ep["r"][i]))
                    self.aggregator.update("Game/ep_len_avg", float(ep["l"][i]))

        self._observe(next_obs)
        rewards = np.asarray(rewards, np.float32).reshape(1, n, 1)
        step_data["rewards"] = np.tanh(rewards) if self.clip_rewards else rewards
        step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, n, 1)
        step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, n, 1)

        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            # the terminal transition with the true final obs (SAME_STEP
            # autoreset keeps it in infos) and a zero action, then the
            # per-env episode state restarts
            final = {k: np.stack([infos["final_obs"][i][k] for i in dones_idxes]) for k in self.obs_keys}
            prepared_final = prepare_obs(final, cnn_keys=self.cnn_keys, num_envs=len(dones_idxes))
            reset_data = {k: prepared_final[k][np.newaxis] for k in self.obs_keys}
            for k in ("terminated", "truncated", "rewards"):
                reset_data[k] = step_data[k][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(sum(self.actions_dim))), np.float32)
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            rb.add(reset_data, dones_idxes, validate_args=self.validate_args)
            for k in ("rewards", "terminated", "truncated"):
                step_data[k][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            self.player.init_states(dones_idxes)


@dataclass
class LoopState:
    """A Dreamer-family loop's sequence replay, counters, ``Ratio`` and
    random streams (JAX :584-602, :722-736), fresh or restored from a
    checkpoint."""

    rb: Any
    start_step: int
    policy_step: int
    last_log: int
    last_checkpoint: int
    num_updates: int
    learning_starts: int
    batch_size: int
    ratio: Ratio
    train_gen: torch.Generator
    player_gen: torch.Generator
    # the in-graph replay draw of a fused superstep
    sample_gen: torch.Generator


def loop_state(
    cfg: Dict[str, Any],
    device: torch.device,
    obs_space: Any,
    actions_dim: Sequence[int],
    log_dir: str,
    state: Optional[Mapping[str, Any]],
    buffer_state: Optional[Mapping[str, Any]] = None,
    player_device: Optional[torch.device] = None,
    rb: Any = None,
) -> LoopState:
    """The replay where ``buffer.device`` puts it (``buffer_state["rb"]``,
    of either buffer mode, loaded into it when given) and, from a resumed
    ``state``, its counters, ``Ratio`` and streams (the player's on
    ``player_device``, by default ``device``); ``learning_starts`` moves
    past the resume point unless ``buffer.checkpoint`` restored the
    buffer. A given ``rb`` (Dreamer-V2's episode buffer) replaces the
    sequence replay."""
    algo, buffer_cfg = cfg["algo"], cfg["buffer"]
    seed, num_envs = int(cfg["seed"]), int(cfg["env"]["num_envs"])
    dry_run = bool(cfg.get("dry_run", False))
    obs_keys = list(algo["cnn_keys"]["encoder"]) + list(algo["mlp_keys"]["encoder"])
    buffer_size = int(buffer_cfg["size"]) // num_envs if not dry_run else 2
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    if rb is None:
        rb = make_sequential_replay(cfg, device, obs_space, actions_dim, buffer_size, num_envs, obs_keys, memmap_dir, seed)
    if buffer_state is not None:
        ring = isinstance(rb, DeviceReplayBuffer)
        rb = adapt_restored_buffer(
            select_buffer(buffer_state["rb"], 0, 1), ring, seed=seed, memmap=bool(buffer_cfg["memmap"]), memmap_dir=memmap_dir, device=device
        )
    ls = LoopState(
        rb=rb,
        start_step=1,
        policy_step=0,
        last_log=0,
        last_checkpoint=0,
        num_updates=int(algo["total_steps"]) // num_envs if not dry_run else 1,
        learning_starts=int(algo["learning_starts"]) // num_envs if not dry_run else 0,
        batch_size=int(algo["per_rank_batch_size"]),
        ratio=Ratio(float(algo["replay_ratio"]), pretrain_steps=int(algo["per_rank_pretrain_steps"])),
        train_gen=torch.Generator(device=device).manual_seed(seed),
        player_gen=torch.Generator(device=player_device or device).manual_seed(stream_seed(seed, 1)),
        sample_gen=torch.Generator(device=device).manual_seed(stream_seed(seed, SAMPLE_KEY_SALT)),
    )
    if state is not None:
        update = int(state["update"])
        ls.start_step, ls.policy_step = update + 1, update * num_envs
        ls.last_log, ls.last_checkpoint = int(state["last_log"]), int(state["last_checkpoint"])
        ls.batch_size = elastic_per_rank_batch_size(int(state["batch_size"]), 1)
        if not buffer_cfg["checkpoint"]:
            ls.learning_starts += ls.start_step
        ls.ratio.load_state_dict(state["ratio"])
        restore_generator(ls.train_gen, state["rng_key"], seed, update)
        restore_generator(ls.player_gen, state["player_rng_key"], seed, update, 1)
        if "sample_rng_key" in state:
            restore_generator(ls.sample_gen, state["sample_rng_key"], seed, update, SAMPLE_KEY_SALT)
    return ls


def place_dreamer_player(player: Any, cfg: Mapping[str, Any], device: torch.device) -> Any:
    """The player on ``algo.player_device`` (JAX ``agent.py:982``): on the
    host, it acts on its own copy of the acting modules."""
    target = resolve_player_device(cfg["algo"].get("player_device", "auto"), device) or device
    place_player(player, target)
    print(f"Dreamer player on {player.device}, training on {device}")
    return player


def replay_kind(rb: Any) -> str:
    """``device`` (the ring), ``memmap`` or ``host``."""
    return "device" if isinstance(rb, DeviceReplayBuffer) else ("memmap" if all(rb.is_memmap) else "host")


class ReplayTrainer:
    """The train windows of the Dreamer-family loops (JAX :1000-1060). In
    ``window``, each gradient step is one call of the captured step
    ``make_fn(inputs)`` (built at the first window) on a batch the ring
    gathers on the card into ``inputs``, or a pinned prefetcher copies
    there from the host buffer, with ``refresh(tau)`` of the target critics
    every ``per_rank_target_network_update_freq`` steps before it (tau 1
    at step 0; none with ``refresh=None``). A window (``span``) is the
    ``Time/train_time`` span, which ends when the card has finished it
    (through the dispatch fence), and its start and end on the card's
    clock. Metric vectors stay on the
    device in ``pending`` until log time. With telemetry on, a window
    reports its dispatches and marks the run warm, and the step's FLOPs
    feed MFU."""

    def __init__(self, cfg: Dict[str, Any], rb: Any, batch_size: int, make_fn: Any, refresh: Any, device: torch.device) -> None:
        algo = cfg["algo"]
        self.rb, self.batch_size, self.make_fn, self.refresh, self.device = rb, batch_size, make_fn, refresh, device
        self.sequence_length = int(algo["per_rank_sequence_length"])
        self.cnn_keys = list(algo["cnn_keys"]["encoder"])
        self.prefetch = int(cfg["buffer"]["prefetch"])
        # no refresh (Dreamer-V1's critic has no target): 0
        self.ema_every = int(algo["critic"].get("per_rank_target_network_update_freq", 0) or 0) if refresh is not None else 0
        # a hard copy (Dreamer-V2) has no tau
        self.tau = float(algo["critic"].get("tau", 1.0))
        self.keep = int(cfg["metric"]["log_level"]) > 0
        self.count_flops = get_telemetry() is not None
        self.fence = DispatchFence(device, depth=int(algo.get("dispatch_fence_depth", 4) or 4))
        self.fn: Optional[CapturedStep] = None
        self.prefetcher: Optional[BatchPrefetcher] = None
        self.pending: List[torch.Tensor] = []
        self.last: Optional[torch.Tensor] = None
        self.steps = self.windows = 0
        self.window_times: List[Tuple[Any, Any]] = []  # each window's (start, end) events or clock times

    @contextlib.contextmanager
    def span(self) -> Iterator[None]:
        """One train window."""
        with timer("Time/train_time"):
            start = _clock(self.device)
            yield
            self.window_times.append((start, _clock(self.device)))
            self.fence.push()
            if not timer.disabled:
                self.fence.drain()
        self.windows += 1

    def window(self, n_steps: int) -> None:
        """``n_steps`` gradient steps, one replay each."""
        ring = isinstance(self.rb, DeviceReplayBuffer)
        if self.fn is None:
            inputs = batch_inputs(self.rb, self.sequence_length, self.batch_size, self.cnn_keys, self.device)
            self.fn = self.make_fn(inputs)
            self.fn.count_flops = self.count_flops
            if not ring:
                self.prefetcher = BatchPrefetcher(self.rb, self.batch_size, self.sequence_length, inputs, self.prefetch, self.fn.done)
        emas = 0
        with self.span():
            if ring:
                # each batch gathered on the card into the step's inputs,
                # after the replay before it on the same stream
                batches = self.rb.sample_batches(self.batch_size, self.sequence_length, n_steps, out=self.fn.inputs)
            else:
                batches = self.prefetcher.sampled_batches(n_steps)
            for _ in batches:
                if self.ema_every and self.steps % self.ema_every == 0:
                    self.refresh(1.0 if self.steps == 0 else self.tau)
                    emas += 1
                self.last = self.fn()
                self.steps += 1
                if self.steps == 1:
                    telemetry_register_flops(lambda: self.fn.flops)
                if self.keep:
                    self.pending.append(self.last)
        # a replay a step, the ring's gather a step, the target refreshes
        telemetry_train_window(n_steps * (2 if ring else 1) + emas, n_steps)
        # the first window captured the step: a later capture is a recompile
        telemetry_mark_warm()

    def finish(self) -> None:
        """Wait for every dispatched window."""
        self.fence.drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def report(self, order: Sequence[str]) -> Dict[str, Any]:
        """The gradient steps, the windows' seconds, the last metrics by
        name, and the replays with the fused-step calls each relaunches."""
        fn = self.fn
        window_seconds = [_elapsed(a, b) for a, b in self.window_times]
        return {
            "gradient_steps": self.steps,
            "train_seconds": sum(window_seconds),
            "train_window_seconds": window_seconds,
            "metrics": {} if self.last is None else dict(zip(order, self.last.cpu().tolist())),
            "captured_launches_per_step": 0 if fn is None else fn.captured_launches,
            "replays": 0 if fn is None else fn.replays,
        }


class LogWindows:
    """The log windows of the Dreamer-family loops (JAX :1062-1100): the
    trainer's pending metric vectors (per-step vectors and superstep
    blocks), fetched in one copy, into ``aggregator``; its means, the
    replay ratio and the env and train rates to ``logger`` and the means
    to telemetry."""

    def __init__(self, cfg: Dict[str, Any], logger: Any, aggregator: Any, order: Sequence[str], last_log: int) -> None:
        metric_cfg = cfg["metric"]
        self.level, self.every = int(metric_cfg["log_level"]), int(metric_cfg["log_every"])
        self.action_repeat = int(cfg["env"].get("action_repeat", 1) or 1)
        self.logger, self.aggregator, self.order = logger, aggregator, tuple(order)
        self.last_log, self.last_windows, self.last_steps = last_log, 0, 0
        self.logged: List[Tuple[int, Dict[str, float]]] = []

    def maybe_log(self, policy_step: int, last_update: bool, trainer: ReplayTrainer) -> None:
        if self.level <= 0 or not (policy_step - self.last_log >= self.every or last_update):
            return
        if trainer.pending:
            rows = torch.cat([m.reshape(-1, len(self.order)) for m in trainer.pending])
            for row in rows.cpu().numpy():
                for name, value in zip(self.order, row):
                    self.aggregator.update(name, value)
            trainer.pending.clear()
        metrics = self.aggregator.compute()
        self.logger.log_metrics(metrics, policy_step)
        telemetry_run_metrics(metrics)
        self.logged.append((policy_step, metrics))
        self.aggregator.reset()
        if policy_step > 0:
            self.logger.log_metrics({"Params/replay_ratio": trainer.steps / policy_step}, policy_step)
        log_sps_and_heartbeat(
            self.logger,
            policy_step=policy_step,
            env_steps=(policy_step - self.last_log) * self.action_repeat,
            train_steps=trainer.windows - self.last_windows,
            train_invocations=trainer.steps - self.last_steps,
        )
        self.last_log, self.last_windows, self.last_steps = policy_step, trainer.windows, trainer.steps


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
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    ckpt_cfg = cfg["checkpoint"]
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
    resil = RunResilience(cfg, log_dir, callback)
    envs = build_vector_env(cfg, 0, log_dir, "train", restart_on_exception=True)
    obs_space = envs.single_observation_space
    actions_dim, is_continuous = action_dims(envs.single_action_space)
    cnn_keys = list(algo["cnn_keys"]["encoder"])

    wm, actor, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    critic, target_critic = build_critic(cfg, wm.latent_state_size, device=dev)
    opts = build_optimizers(cfg, wm, actor, critic)
    moments = init_moments(dev)
    if state is not None:
        load_checkpoint_state(state, wm, actor, critic, target_critic, opts, moments)
    place_dreamer_player(player, cfg, dev)
    train_step = make_train_step(wm, actor, critic, target_critic, *opts, cfg, is_continuous)

    buffer_cfg = cfg["buffer"]
    # a checkpoint of either buffer mode resumes into this run's mode
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state, state if buffer_cfg["checkpoint"] else None, player.device)
    rb, ratio, batch_size = ls.rb, ls.ratio, ls.batch_size
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint
    use_device_rb = isinstance(rb, DeviceReplayBuffer)
    sequence_length = int(algo["per_rank_sequence_length"])
    fused_k = int(algo.get("fused_gradient_steps", 0) or 0)

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(wm, actor, critic, target_critic, opts, moments),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
            "sample_rng_key": ls.sample_gen.get_state().numpy(),
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
            restore_generator(ls.train_gen, restored["rng_key"], seed, int(restored["update"]))
        if "sample_rng_key" in restored:
            restore_generator(ls.sample_gen, restored["sample_rng_key"], seed, int(restored["update"]), SAMPLE_KEY_SALT)
        resil.resalt_key(ls.train_gen)
        resil.resalt_key(ls.sample_gen)
        trainer.pending.clear()  # the poisoned window must not reach the log
        player.sync_params()

    trainer = ReplayTrainer(
        cfg,
        rb,
        batch_size,
        lambda inputs: make_train_fn(train_step, wm, actor, critic, opts, moments, inputs, ls.train_gen),
        lambda tau: ema_(critic, target_critic, tau),
        dev,
    )
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
                gather = lambda ctx, i: draw_sequence_batch(bufs, pos, full, ls.sample_gen, batch_size, sequence_length)  # noqa: E731
                stack, gens = None, (ls.train_gen, ls.sample_gen)
            else:
                gather, gens = pregathered, (ls.train_gen,)
                stack = batch_inputs(rb, sequence_length, batch_size, cnn_keys, dev, stack=n)
            fn = fused_fns[n] = make_fused_train_fn(
                train_step, wm, actor, critic, target_critic, opts, moments, cfg, gather, n, stack, gens
            )
            fn.count_flops = trainer.count_flops
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
        finite = []
        for n, count in ((fused_k, n_steps // fused_k), (n_steps % fused_k, int(n_steps % fused_k > 0))):
            if count == 0:
                continue
            fn = get_fused_fn(n)
            feeds = itertools.repeat(None, count) if use_device_rb else fused_feeds[n].sampled_batches(count)
            for _ in feeds:
                if use_device_rb:
                    rb.superstep_inputs(sequence_length)
                fn.inputs["counter"].fill_(trainer.steps)
                block, chunk_finite = fn()
                trainer.steps += n
                finite.append(chunk_finite)
                trainer.last = block[-1]
                if trainer.keep:
                    trainer.pending.append(block)
        return finite

    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS)
    env_loop = EnvLoop(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed))
    env_loop.reset(seed)
    logs = LogWindows(cfg, logger, aggregator, METRIC_ORDER, last_log)
    preempted = False
    update = ls.start_step
    resil.arm_crash_guard(
        path_fn=lambda: ckpt_path_fn(policy_step),
        state_fn=lambda: ckpt_state_fn(update - 1),
        replay_buffer_fn=buffer_to_save,
    )
    t_start = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            if resil.preempt_requested():
                trainer.fence.drain()
                last_checkpoint = policy_step
                resil.emergency_checkpoint(ckpt_path_fn(policy_step), ckpt_state_fn(update - 1), buffer_to_save())
                preempted = True
                break
            policy_step += num_envs
            env_loop.step(random=update <= ls.learning_starts and state is None)

            # ---------------- training ---------------- #
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0 and fused_k > 0:
                replays_before = sum(fn.replays for fn in fused_fns.values())
                with trainer.span():
                    finite = superstep_window(n_steps)
                telemetry_train_window(sum(fn.replays for fn in fused_fns.values()) - replays_before, n_steps)
                telemetry_mark_warm()
                # one fetch a window: the finite vectors the supersteps
                # computed in their graphs
                if resil.finite_checks and not resil.window_ok(bool(torch.cat(finite).all()), update):
                    nan_rollback(update)
                    continue
            elif n_steps > 0:
                trainer.window(n_steps)
                # the window's last metric vector: a NaN in the params
                # reaches every later loss (JAX :1047-1055)
                if resil.finite_checks and not resil.check_finite(trainer.last.cpu().numpy(), update):
                    nan_rollback(update)
                    continue
            if n_steps > 0:
                # a placed player's copy lands at a later action (JAX :1075)
                player.stream_params()

            # ---------------- logging ---------------- #
            logs.maybe_log(policy_step, update == ls.num_updates, trainer)
            last_log = logs.last_log

            # ---------------- checkpoint ---------------- #
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == ls.num_updates and ckpt_cfg["save_last"]
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
    trainer.finish()
    seconds = time.perf_counter() - t_start
    envs.close()
    test_reward, test_steps = None, 0
    player.flush_params()
    if algo.get("run_test", False) and not preempted:
        test_reward, test_steps = test(player, cfg, log_dir, greedy=False, logger=logger)
    logger.finalize()
    resil.close()
    if preempted:
        resil.exit_preempted()
    # (steps a replay, captured graph) of the run: the per-step graph, or
    # the superstep graphs by chunk length
    graphs = sorted(fused_fns.items()) if fused_k > 0 else ([(1, trainer.fn)] if trainer.fn is not None else [])
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "seconds": seconds,
        "log": logs.logged,
        "moments": (float(moments.low), float(moments.high)),
        "rollbacks": resil.rollbacks,
        "last_checkpoint": last_checkpoint,
        **trainer.report(METRIC_ORDER),
        # fused_gru launches of the replayed steps: the captured calls a
        # replay relaunches, and the replays
        "captured_launches_per_step": graphs[0][1].captured_launches // graphs[0][0] if graphs else 0,
        "replays": sum(fn.replays for _, fn in graphs),
        "graphs": [{"steps": n, "captured_launches": fn.captured_launches, "replays": fn.replays} for n, fn in graphs],
        "replay_buffer": replay_kind(rb),
        "player_device": str(player.device),
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
