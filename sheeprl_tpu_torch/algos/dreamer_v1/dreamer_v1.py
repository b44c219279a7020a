"""Dreamer-V1 training (port of ``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``:
``make_train_fn`` :78-290 and ``main`` :293-646), on one device.

One gradient step (:func:`make_train_step`): the world model over a
``[T, B]`` batch (``rssm_scan_dv1`` from zero states, the decoders' and the
reward's ``Normal(mean, 1)`` likelihoods, the optional continue model and
the free-nats KL of two Gaussians) and its Adam step; an imagination of
``horizon`` steps from every posterior with the updated world model, whose
``H`` latents (the start is not among them) give ``H - 1`` lambda targets
(``compute_lambda_values_dv1``) against the critic itself (no target
critic); the actor's objective ``-mean(discount * lambda)``, pure dynamics
backpropagation through imagination; the critic fitted to the targets.
Each model's gradients are clipped by its ``clip_gradients``. On the card
the step is one ``CapturedStep`` replay.

``main`` is Dreamer-V2's loop (``dreamer_v2.EnvLoopDV2`` and Dreamer-V3's
``loop_state``, ``ReplayTrainer`` and ``LogWindows``) with the sequence
replay only (JAX :370), ``Ratio``, the exploration-noise amount logged as
``Params/exploration_amount`` after each train window, checkpoints in the
JAX layout and keys, resumed from either package's, and the final test
episode.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import (
    ActorDV1,
    CriticDV1,
    WorldModelDV1,
    build_agent,
    rssm_scan_dv1,
    sample_actor_actions,
)
from sheeprl_tpu_torch.algos.dreamer_v1.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import AGGREGATOR_KEYS, test
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import EnvLoopDV2, check_keys, make_train_fn
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    LogWindows,
    ReplayTrainer,
    _grads,
    build_optimizers,
    loop_state,
    place_dreamer_player,
    replay_kind,
    resolve_fabric,
)
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.ops.distributions import Bernoulli, Independent, Normal
from sheeprl_tpu_torch.ops.math import compute_lambda_values_dv1
from sheeprl_tpu_torch.ops.optim import Adam
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

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
TrainStep = Callable[..., torch.Tensor]


def world_model_step(wm: WorldModelDV1, world_opt: Adam, data: Dict[str, torch.Tensor], cfg: Dict[str, Any], generator: Optional[torch.Generator], detach_heads: bool = False):
    """The world model's loss over the batch and its Adam step (JAX
    :125-177); ``detach_heads`` feeds the reward and continue heads detached
    latents, as P2E does. Returns ``(embedded, hs, zs, metrics [8], grad
    norm, grads)``, ``metrics`` the first eight of ``METRIC_ORDER``."""
    algo = cfg["algo"]
    wmc = algo["world_model"]
    cnn_keys, mlp_keys = tuple(algo["cnn_keys"]["encoder"]), tuple(algo["mlp_keys"]["encoder"])
    cnn_dec, mlp_dec = tuple(algo["cnn_keys"]["decoder"]), tuple(algo["mlp_keys"]["decoder"])
    obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_dec}
    obs_targets.update({k: data[k].float() for k in mlp_dec})
    embedded = wm.encode({k: data[k] for k in cnn_keys + mlp_keys})
    hs, zs, post_mean, post_std, prior_mean, prior_std = rssm_scan_dv1(wm, embedded, data["actions"], generator)
    latents = torch.cat([zs, hs], -1)
    recon = wm.decode(latents)
    qo = {k: Independent(Normal(recon[k], torch.ones_like(recon[k])), 3 if k in cnn_dec else 1) for k in cnn_dec + mlp_dec}
    head_in = latents.detach() if detach_heads else latents
    reward_mean = wm.reward_mean(head_in)
    qr = Independent(Normal(reward_mean, torch.ones_like(reward_mean)), 1)
    qc = continue_targets = None
    if bool(wmc["use_continues"]):
        qc = Independent(Bernoulli(wm.continue_logits(head_in)), 1)
        continue_targets = (1 - data["terminated"]) * float(algo["gamma"])
    rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
        qo,
        obs_targets,
        qr,
        data["rewards"],
        post_mean,
        post_std,
        prior_mean,
        prior_std,
        float(wmc["kl_free_nats"]),
        float(wmc["kl_regularizer"]),
        qc,
        continue_targets,
        float(wmc["continue_scale_factor"]),
    )
    grads = _grads(rec_loss, list(wm.parameters()))
    gnorm = world_opt.step(grads)
    with torch.no_grad():
        post_ent = Independent(Normal(post_mean.detach(), post_std.detach()), 1).entropy().mean()
        prior_ent = Independent(Normal(prior_mean.detach(), prior_std.detach()), 1).entropy().mean()
    metrics = [rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, post_ent, prior_ent]
    return embedded, hs, zs, metrics, gnorm, grads


def imagine(wm: WorldModelDV1, actor: ActorDV1, start_z: torch.Tensor, start_h: torch.Tensor, horizon: int, generator: Optional[torch.Generator]):
    """Imagination from ``(start_z, start_h)`` (JAX :187-203): ``horizon``
    stepped prior latents ``[H, N, L]`` (the start is not stored), each
    reached by an action sampled at the latent before it, and those
    actions ``[H, N, A]``."""
    z, h = start_z, start_h
    lats, acts = [], []
    for _ in range(horizon):
        action = sample_actor_actions(actor, torch.cat([z, h], -1).detach(), generator)
        z, h = wm.imagination(z, h, action, generator)
        lats.append(torch.cat([z, h], -1))
        acts.append(action)
    return torch.stack(lats), torch.stack(acts)


def continues_of(wm: WorldModelDV1, trajectories: torch.Tensor, like: torch.Tensor, use_continues: bool, gamma: float) -> torch.Tensor:
    """The continue model's probabilities on ``trajectories``, or
    ``gamma`` everywhere without one."""
    if use_continues:
        return torch.sigmoid(wm.continue_logits(trajectories))
    return torch.ones_like(like) * gamma


def behaviour_targets(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float):
    """``(lambda_values [H-1], discount [H-1])`` of an imagination (JAX
    :213-218): the discount is the detached running product of the
    continues before each step."""
    lambda_values = compute_lambda_values_dv1(rewards, values, continues, lmbda)
    discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], 0), 0).detach()
    return lambda_values, discount


def value_loss(critic: CriticDV1, trajectories: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The critic's discounted ``Normal(v, 1)`` negative log-likelihood of
    the detached targets on the detached imagination (JAX :247-251)."""
    qv = critic(trajectories[:-1].detach())
    return -torch.mean(discount[..., 0] * Independent(Normal(qv, torch.ones_like(qv)), 1).log_prob(lambda_values.detach()))


def make_train_step(
    wm: WorldModelDV1,
    actor: ActorDV1,
    critic: CriticDV1,
    world_opt: Adam,
    actor_opt: Adam,
    critic_opt: Adam,
    cfg: Dict[str, Any],
) -> TrainStep:
    """``train_step(data, generator=None, grads_out=None) -> metrics [13]``
    (``METRIC_ORDER``), one gradient step over the ``[T, B, ...]`` batch
    ``data`` (obs keys, ``actions``, ``rewards``, ``terminated``), the
    three models and their optimizers updated in place; ``grads_out``, a
    dict, receives each model's gradients before clipping
    (``world_model``, ``actor``, ``critic``)."""
    algo = cfg["algo"]
    horizon, gamma, lmbda = int(algo["horizon"]), float(algo["gamma"]), float(algo["lmbda"])
    use_continues = bool(algo["world_model"]["use_continues"])

    def train_step(
        data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, grads_out: Optional[Dict[str, List[torch.Tensor]]] = None
    ) -> torch.Tensor:
        T, B = data["rewards"].shape[:2]
        _, hs, zs, wm_metrics, wm_gnorm, wm_grads = world_model_step(wm, world_opt, data, cfg, generator)

        # the actor: dynamics backpropagation through imagination with the
        # updated world model (JAX :187-230)
        trajectories, _ = imagine(wm, actor, zs.detach().reshape(T * B, -1), hs.detach().reshape(T * B, -1), horizon, generator)
        values = critic(trajectories)
        rewards = wm.reward_mean(trajectories)
        continues = continues_of(wm, trajectories, rewards, use_continues, gamma)
        lambda_values, discount = behaviour_targets(rewards, values, continues, lmbda)
        policy_loss = -torch.mean(discount * lambda_values)
        actor_grads = _grads(policy_loss, list(actor.parameters()))
        actor_gnorm = actor_opt.step(actor_grads)

        # the critic against the targets (JAX :243-256)
        critic_loss = value_loss(critic, trajectories, lambda_values, discount)
        critic_grads = _grads(critic_loss, list(critic.parameters()))
        critic_gnorm = critic_opt.step(critic_grads)

        if grads_out is not None:
            grads_out.update(world_model=wm_grads, actor=actor_grads, critic=critic_grads)
        return torch.stack([*wm_metrics, policy_loss, critic_loss, wm_gnorm, actor_gnorm, critic_gnorm]).detach()

    return train_step


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train Dreamer-V1, called as the CLI calls it, ``main(fabric, cfg)``,
    or as ``main(cfg, device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps (one update with
    ``dry_run``), as the JAX ``main`` runs it on one device. Returns the
    run's counts, seconds and metrics."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg, buffer_cfg = cfg["algo"], cfg["checkpoint"], cfg["buffer"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    # these arguments cannot be changed (JAX :297-300): the decoder
    # reconstructs 64x64 exactly
    cfg["env"]["screen_size"] = 64
    cfg["env"]["frame_stack"] = 1
    check_keys(cfg)
    num_envs = int(cfg["env"]["num_envs"])
    log_dir = get_log_dir(cfg)
    logger = fabric.logger = get_logger(cfg, log_dir)
    logger.log_hyperparams(cfg)
    print(f"Log dir: {log_dir}")
    save_configs(cfg, log_dir)
    envs = build_vector_env(cfg, 0, log_dir, "train", restart_on_exception=True)
    obs_space = envs.single_observation_space
    actions_dim, is_continuous = action_dims(envs.single_action_space)

    wm, actor, critic, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    opts = build_optimizers(cfg, wm, actor, critic)
    if state is not None:
        load_checkpoint_state(state, wm, actor, critic, opts)
    place_dreamer_player(player, cfg, dev)
    train_step = make_train_step(wm, actor, critic, *opts, cfg)

    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state, state if buffer_cfg["checkpoint"] else None, player.device)
    rb, ratio = ls.rb, ls.ratio
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(wm, actor, critic, opts),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": ls.batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
        }

    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS)
    env_loop = EnvLoopDV2(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed), close_first_in_dry_run=False)
    env_loop.reset(seed)
    # no target critic: nothing to refresh between replays
    trainer = ReplayTrainer(
        cfg, rb, ls.batch_size, lambda inputs: make_train_fn(train_step, wm, actor, critic, opts, inputs, ls.train_gen), None, dev
    )
    logs = LogWindows(cfg, logger, aggregator, METRIC_ORDER, last_log)
    log_level = int(cfg["metric"]["log_level"])
    update_seconds: List[float] = []
    t_start = t_update = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            policy_step += num_envs
            env_loop.step(random=update <= ls.learning_starts and state is None, policy_step=policy_step)
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0:
                trainer.window(n_steps)
                # a placed player's copy lands at a later action (JAX :565-566)
                player.stream_params()
                if log_level > 0:
                    aggregator.update("Params/exploration_amount", actor.get_expl_amount(policy_step))
            logs.maybe_log(policy_step, update == ls.num_updates, trainer)
            last_log = logs.last_log
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == ls.num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
                callback.on_checkpoint_coupled(path, ckpt_state_fn(update), rb if buffer_cfg["checkpoint"] else None)
            update_seconds.append(time.perf_counter() - t_update)
            t_update = time.perf_counter()
    except BaseException:
        logger.finalize()
        envs.close()
        raise
    trainer.finish()
    seconds = time.perf_counter() - t_start
    envs.close()
    # the test plays the last window's params (JAX :642-644)
    player.flush_params()
    test_reward, test_steps = None, 0
    if algo.get("run_test", False):
        test_reward, test_steps = test(player, cfg, log_dir, greedy=False, logger=logger)
    logger.finalize()
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "seconds": seconds,
        "update_seconds": update_seconds,
        "log": logs.logged,
        "last_checkpoint": last_checkpoint,
        **trainer.report(METRIC_ORDER),
        "replay_buffer": replay_kind(rb),
        "player_device": str(player.device),
        "exploration_amount": actor.get_expl_amount(policy_step),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }
