"""Plan2Explore on Dreamer-V3, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``: ``make_train_fn``
:101-470 and ``main`` :474-953).

One gradient step runs the five updates of the JAX step in its order:

1. the world model, as Dreamer-V3's, with the reward and continue heads
   reading detached latents;
2. the ensemble: the sum over members of each member's mean negative
   log-likelihood (MSE) of the next posterior, from ``(z, h, action)``;
3. the exploration actor over one imagination shared by every exploration
   critic: the intrinsic reward is the ensemble's disagreement, the
   population variance (ddof 0) of the members' predictions averaged over
   the state, and each critic's normalised advantage is mixed in by
   ``weight / sum of weights``;
4. each exploration critic against its own EMA target;
5. the task actor and critic over a second imagination, as Dreamer-V3's
   behaviour step (learned zero-shot from exploration data).

Both imaginations and the observation scan run the fused RSSM step (B1) on
the card. ``main`` is Dreamer-V3's host loop (``dreamer_v3.EnvLoop``,
``loop_state``, ``ReplayTrainer``, ``LogWindows``) with this step replayed
from one CUDA graph (``CapturedStep``), the task target
and every exploration target refreshed by EMA between replays, the
exploration actor on the player, checkpoints in the JAX layout
(``convert.checkpoint_state``), resume from the port's or the JAX package's
checkpoints, and the zero-shot test of the task actor at the end. As the
JAX ``main``, it has no fused superstep and no NaN rollback.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    EnvLoop,
    LogWindows,
    ReplayTrainer,
    _grads,
    behaviour_step,
    critic_loss,
    ema_,
    imagination_start,
    imagine,
    loop_state,
    place_dreamer_player,
    policy_loss,
    replay_kind,
    resolve_fabric,
    train_hparams,
    world_model_step,
)
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EAgent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.p2e_dv3.utils import test
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.ops.distributions import Bernoulli, Independent, MSEDistribution, TwoHotEncodingDistribution
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.math import MomentsState, compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.ops.optim import Adam, adam
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

BASE_METRIC_ORDER = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/ensemble_loss",
    "Loss/policy_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Grads/world_model",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
)
PER_CRITIC_METRICS = (
    "Loss/value_loss_exploration_{k}",
    "Values_exploration/predicted_values_{k}",
    "Values_exploration/lambda_values_{k}",
    "Grads/critic_exploration_{k}",
    "Rewards/intrinsic_{k}",
)
# the config's generic exploration metrics, one per critic in the aggregator
GENERIC_METRICS = (
    "Loss/value_loss_exploration",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/critic_exploration",
    "Rewards/intrinsic",
)


def metric_order(critic_keys: Sequence[str]) -> Tuple[str, ...]:
    """The names of a step's metric vector, the per-critic ones by key."""
    order = list(BASE_METRIC_ORDER)
    for k in critic_keys:
        order += [m.format(k=k) for m in PER_CRITIC_METRICS]
    return tuple(order)


def build_optimizers(cfg: Dict[str, Any], agent: P2EAgent) -> Dict[str, Adam]:
    """Every optimizer of the exploration phase, keyed by its checkpoint
    key: Dreamer-V3's three, the ensemble's, the exploration actor's (the
    actor's settings) and one per exploration critic (the critic's)."""
    algo = cfg["algo"]
    world, actor, critic = dv3.build_optimizers(cfg, agent.world_model, agent.actor_task, agent.critic_task)
    opts = {
        "world_optimizer": world,
        "actor_task_optimizer": actor,
        "critic_task_optimizer": critic,
        "ensemble_optimizer": adam(
            list(agent.ensembles.parameters()), algo["ensembles"]["optimizer"], algo["ensembles"]["clip_gradients"]
        ),
        "actor_exploration_optimizer": adam(
            list(agent.actor_exploration.parameters()), algo["actor"]["optimizer"], algo["actor"]["clip_gradients"]
        ),
    }
    for k, c in agent.critics_exploration.items():
        opts[f"critic_exploration_optimizer_{k}"] = adam(
            list(c["critic"].parameters()), algo["critic"]["optimizer"], algo["critic"]["clip_gradients"]
        )
    return opts


def intrinsic_reward(ensemble: torch.nn.Module, trajectories: torch.Tensor, actions: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The ensemble's disagreement on an imagination, ``[H+1, N, 1]``: the
    members' population variance (ddof 0, as ``jnp.var``), averaged over
    the predicted state, times ``multiplier``."""
    with torch.no_grad():
        preds = ensemble(torch.cat([trajectories.detach(), actions.detach()], -1))
        return preds.var(0, correction=0).mean(-1, keepdim=True) * multiplier


def ensemble_loss(ensemble: torch.nn.Module, zs: torch.Tensor, hs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Each member predicts the next posterior from ``(z_t, h_t, a_t)``:
    the sum over members of each member's mean MSE negative
    log-likelihood."""
    outs = ensemble(torch.cat([zs.detach(), hs.detach(), actions], -1))[:, :-1]
    target = zs.detach()[1:].expand_as(outs)
    return -MSEDistribution(outs, dims=1).log_prob(target).mean((1, 2)).sum()


def make_train_step(agent: P2EAgent, opts: Mapping[str, Adam], cfg: Dict[str, Any], is_continuous: bool):
    """One exploration gradient step over a time-major ``[T, B]`` batch.

    Returns ``train_step(moments_task, moments_exploration, data,
    generator=None, grads_out=None) -> metrics``: it updates every model,
    optimizer and Moments in place and returns the metrics of
    ``metric_order`` as one device tensor. ``grads_out``, a dict, receives
    each model's gradients before clipping, keyed ``world_model``,
    ``ensembles``, ``actor_exploration``, ``actor_task``, ``critic_task``
    and ``critic_exploration_<k>``."""
    hp = train_hparams(cfg)
    gamma, lmbda = hp["gamma"], hp["lmbda"]
    multiplier = float(cfg["algo"]["intrinsic_reward_multiplier"])
    wm, ensemble, actor_expl = agent.world_model, agent.ensembles, agent.actor_exploration
    # a static, ordered loop: one CUDA graph holds every critic's update
    critics = agent.critics_exploration
    weights_sum = sum(c["weight"] for c in critics.values())

    def train_step(
        moments_task: MomentsState,
        moments_exploration: Mapping[str, MomentsState],
        data: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        grads_out: Optional[Dict[str, List[torch.Tensor]]] = None,
    ) -> torch.Tensor:
        # 1. the world model
        hs, zs, wm_metrics, wm_gnorm, wm_grads = world_model_step(
            wm, opts["world_optimizer"], data, generator, hp, detach_heads=True
        )
        # 2. the ensemble
        ens_loss = ensemble_loss(ensemble, zs, hs, data["actions"])
        ens_grads = _grads(ens_loss, list(ensemble.parameters()))
        ens_gnorm = opts["ensemble_optimizer"].step(ens_grads)

        # 3. the exploration actor, on the updated world model and ensemble
        start = imagination_start(zs, hs, data["terminated"])
        start_z, start_h, true_continue = start
        with torch.set_grad_enabled(is_continuous):
            trajectories, actions = imagine(wm, actor_expl, start_z, start_h, hp["horizon"], generator)
            continues = Independent(Bernoulli(wm.continue_logits(trajectories)), 1).mode
            continues = torch.cat([true_continue[None], continues[1:]], 0)
            intrinsic = intrinsic_reward(ensemble, trajectories, actions, multiplier)
            advantage: Any = 0
            per_critic = {}
            for k, c in critics.items():
                values = TwoHotEncodingDistribution(c["critic"](trajectories), dims=1).mean
                if c["reward_type"] == "intrinsic":
                    reward = intrinsic
                else:
                    reward = TwoHotEncodingDistribution(wm.reward_logits(trajectories), dims=1).mean
                lambda_values = compute_lambda_values(reward[1:], values[1:], continues[1:] * gamma, lmbda)
                new, (offset, invscale) = update_moments(moments_exploration[k], lambda_values, **hp["moments_args"])
                moments_exploration[k].low.copy_(new.low)
                moments_exploration[k].high.copy_(new.high)
                normed = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
                advantage = advantage + normed * c["weight"] / weights_sum
                per_critic[k] = (lambda_values, values)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
        expl_loss = policy_loss(actor_expl, trajectories, actions, advantage, discount, hp["ent_coef"], is_continuous)
        expl_grads = _grads(expl_loss, list(actor_expl.parameters()))
        expl_gnorm = opts["actor_exploration_optimizer"].step(expl_grads)

        # 4. the exploration critics
        traj_in = trajectories[:-1].detach()
        critic_metrics, critic_grads = [], {}
        for k, c in critics.items():
            lambda_values, values = per_critic[k]
            value_loss = critic_loss(c["critic"], c["target"], traj_in, lambda_values, discount)
            grads = critic_grads[f"critic_exploration_{k}"] = _grads(value_loss, list(c["critic"].parameters()))
            gnorm = opts[f"critic_exploration_optimizer_{k}"].step(grads)
            reward_mean = intrinsic.mean() if c["reward_type"] == "intrinsic" else torch.zeros_like(intrinsic[0, 0, 0])
            critic_metrics += [value_loss, values.detach().mean(), lambda_values.detach().mean(), gnorm, reward_mean]

        # 5. the task actor and critic (zero-shot)
        task_losses, task_gnorms, (actor_grads, critic_task_grads) = behaviour_step(
            wm,
            agent.actor_task,
            agent.critic_task,
            agent.target_critic_task,
            opts["actor_task_optimizer"],
            opts["critic_task_optimizer"],
            moments_task,
            start,
            generator,
            hp,
            is_continuous,
        )
        metrics = [*wm_metrics, ens_loss, expl_loss, *task_losses, wm_gnorm, ens_gnorm, expl_gnorm, *task_gnorms]
        if grads_out is not None:
            grads_out.update(
                world_model=wm_grads,
                ensembles=ens_grads,
                actor_exploration=expl_grads,
                actor_task=actor_grads,
                critic_task=critic_task_grads,
                **critic_grads,
            )
        return torch.stack(metrics + critic_metrics).detach()

    return train_step


def trained_modules(agent: P2EAgent) -> List[torch.nn.Module]:
    """Every module a gradient step updates, in a fixed order."""
    critics = [c["critic"] for c in agent.critics_exploration.values()]
    return [agent.world_model, agent.ensembles, agent.actor_exploration, agent.actor_task, agent.critic_task, *critics]


def make_train_fn(
    train_step: Any,
    agent: P2EAgent,
    opts: Mapping[str, Adam],
    moments_task: MomentsState,
    moments_exploration: Mapping[str, MomentsState],
    inputs: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
) -> CapturedStep:
    """``train_step`` over the static batch ``inputs`` as a
    ``CapturedStep``: replayed from one CUDA graph on the card, eager on the
    CPU; it updates every trained model, optimizer and Moments in place."""
    state = [p for m in trained_modules(agent) for p in m.parameters()]
    for opt in opts.values():
        state += opt.state_tensors()
    for m in (moments_task, *moments_exploration.values()):
        state += [m.low, m.high]
    return CapturedStep(lambda data: train_step(moments_task, moments_exploration, data, generator), inputs, state, generator)


def refresh_targets(agent: P2EAgent, tau: float) -> None:
    """The task target and every exploration target critic, by EMA."""
    ema_(agent.critic_task, agent.target_critic_task, tau)
    for c in agent.critics_exploration.values():
        ema_(c["critic"], c["target"], tau)


def check_keys(cfg: Dict[str, Any]) -> None:
    """The decoder keys must be encoder keys, and the two must meet."""
    algo = cfg["algo"]
    cnn, mlp = set(algo["cnn_keys"]["encoder"]), set(algo["mlp_keys"]["encoder"])
    cnn_dec, mlp_dec = set(algo["cnn_keys"]["decoder"]), set(algo["mlp_keys"]["decoder"])
    if not cnn & cnn_dec and not mlp & mlp_dec:
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if cnn_dec - cnn:
        raise RuntimeError("The CNN keys of the decoder must be contained in the encoder ones.")
    if mlp_dec - mlp:
        raise RuntimeError("The MLP keys of the decoder must be contained in the encoder ones.")


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Explore with Plan2Explore, called as the CLI calls it, ``main(fabric,
    cfg)``, or as ``main(cfg, device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps, as the JAX
    ``main`` runs it on one accelerator: uniform random actions up to
    ``algo.learning_starts`` on a fresh run, then the player with the
    exploration actor; sequence replay where ``buffer.device`` puts it;
    ``Ratio``'s gradient steps, each one replay of the captured step with
    the target critics' EMA between replays; checkpoints in the JAX layout;
    resume from ``checkpoint.resume_from`` (a path or ``auto``); the
    zero-shot test episode of the task actor with ``algo.run_test``.
    Returns the run's counts, seconds and metrics."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg = cfg["algo"], cfg["checkpoint"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    # these arguments cannot be changed (JAX :479-480)
    cfg["env"]["frame_stack"] = 1
    algo["player"]["actor_type"] = "exploration"
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

    agent = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    critic_keys = tuple(agent.critics_exploration)
    opts = build_optimizers(cfg, agent)
    moments_task = init_moments(dev)
    moments_exploration = {k: init_moments(dev) for k in critic_keys}
    if state is not None:
        load_checkpoint_state(state, agent, opts, moments_task, moments_exploration)
    train_step = make_train_step(agent, opts, cfg, is_continuous)
    order = metric_order(critic_keys)

    # the generic exploration metrics, one per critic key (JAX :590-598)
    aggregator = build_aggregator(cfg, ())
    for name in GENERIC_METRICS:
        aggregator.metrics.pop(name, None)
    for name in ("Rewards/rew_avg", "Game/ep_len_avg") + order:
        if name not in aggregator.metrics:
            aggregator.add(name, "mean")

    buffer_cfg = cfg["buffer"]
    place_dreamer_player(agent.player, cfg, dev)
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state, state if buffer_cfg["checkpoint"] else None, agent.player.device)
    rb, ratio = ls.rb, ls.ratio
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(agent, opts, moments_task, moments_exploration),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": ls.batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
        }

    env_loop = EnvLoop(envs, rb, agent.player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed))
    env_loop.reset(seed)
    trainer = ReplayTrainer(
        cfg,
        rb,
        ls.batch_size,
        lambda inputs: make_train_fn(train_step, agent, opts, moments_task, moments_exploration, inputs, ls.train_gen),
        lambda tau: refresh_targets(agent, tau),
        dev,
    )
    logs = LogWindows(cfg, logger, aggregator, order, last_log)
    t_start = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            policy_step += num_envs
            env_loop.step(random=update <= ls.learning_starts and state is None)
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0:
                trainer.window(n_steps)
                # a placed player's copy lands at a later action (JAX :859-860)
                agent.player.stream_params()
            logs.maybe_log(policy_step, update == ls.num_updates, trainer)
            last_log = logs.last_log
            if (int(ckpt_cfg["every"]) > 0 and policy_step - last_checkpoint >= int(ckpt_cfg["every"])) or (
                update == ls.num_updates and ckpt_cfg["save_last"]
            ):
                last_checkpoint = policy_step
                path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
                callback.on_checkpoint_coupled(path, ckpt_state_fn(update), rb if buffer_cfg["checkpoint"] else None)
    except BaseException:
        logger.finalize()
        envs.close()
        raise
    trainer.finish()
    seconds = time.perf_counter() - t_start
    envs.close()
    # the task actor's zero-shot test (JAX :950-952)
    test_reward, test_steps = None, 0
    agent.player.flush_params()
    if algo.get("run_test", False):
        agent.player.actor = agent.actor_task
        test_reward, test_steps = test(agent.player, cfg, log_dir, "zero-shot", greedy=False, logger=logger)
    logger.finalize()
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "seconds": seconds,
        "log": logs.logged,
        "moments_task": (float(moments_task.low), float(moments_task.high)),
        "last_checkpoint": last_checkpoint,
        **trainer.report(order),
        "replay_buffer": replay_kind(rb),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }
