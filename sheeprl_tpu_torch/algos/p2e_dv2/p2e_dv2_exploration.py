"""Plan2Explore on Dreamer-V2, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``: ``make_train_fn``
:76-383 and ``main`` :386-814).

One gradient step runs the JAX step's updates in its order:

1. the world model, as Dreamer-V2's (KL balancing), with the reward and
   continue heads reading detached latents;
2. the ensemble in posterior space: the sum over members of each member's
   mean ``Normal(pred, 1)`` negative log-likelihood of the next posterior,
   from ``(z, h, action)``;
3. the exploration actor on the updated world model and ensemble: the
   intrinsic reward is the members' population variance (ddof 0, as
   ``jnp.var``) averaged over the state, times
   ``intrinsic_reward_multiplier``; lambda targets bootstrapped from the
   **target** exploration critic; REINFORCE for discrete actions, dynamics
   backpropagation for continuous ones, with the entropy bonus;
4. the exploration critic against those targets;
5. the task actor and critic over a second imagination, the same objective
   on the world model's reward (learned zero-shot from exploration data).

Both target critics are hard copies of their critics every
``per_rank_target_network_update_freq`` steps (JAX :515), from step 0.

:func:`exploration_main` is the JAX ``main``, shared with P2E over
Dreamer-V1: Dreamer-V2's env loop (``EnvLoopDV2``) and Dreamer-V3's
``loop_state``, ``ReplayTrainer`` and ``LogWindows``, the step replayed
from one CUDA graph (``CapturedStep``) on the card, the exploration actor
on the player, checkpoints in the JAX layout and keys, resume from the
port's or the JAX package's checkpoints, and the zero-shot test of the
task actor at the end.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.agent import actor_logprob_entropy
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import EnvLoopDV2, check_keys, hard_copy_
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import LogWindows, ReplayTrainer, _grads, loop_state, place_dreamer_player, replay_kind, resolve_fabric
from sheeprl_tpu_torch.algos.p2e_dv2.agent import P2EDV2Agent, build_agent, models_of
from sheeprl_tpu_torch.algos.p2e_dv2.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.p2e_dv2.utils import test
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.ops.distributions import Independent, Normal
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.ops.math import compute_lambda_values_bootstrap
from sheeprl_tpu_torch.ops.optim import Adam, adam
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

# the step's metric vector, in the JAX order (P2E over Dreamer-V1 too)
METRIC_ORDER = (
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
    "Loss/value_loss_exploration",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/world_model",
    "Grads/ensemble",
    "Grads/actor_exploration",
    "Grads/critic_exploration",
    "Grads/actor_task",
    "Grads/critic_task",
)


def build_optimizers(cfg: Mapping[str, Any], agent: Any) -> Dict[str, Adam]:
    """The six optimizers of the exploration phase, keyed by their
    checkpoint keys: the world model's, each actor's (the actor's
    settings), each critic's (the critic's) and the ensemble's."""
    algo = cfg["algo"]
    groups = {
        "world_optimizer": ("world_model", "world_model"),
        "actor_task_optimizer": ("actor_task", "actor"),
        "critic_task_optimizer": ("critic_task", "critic"),
        "actor_exploration_optimizer": ("actor_exploration", "actor"),
        "critic_exploration_optimizer": ("critic_exploration", "critic"),
        "ensemble_optimizer": ("ensembles", "ensembles"),
    }
    return {
        key: adam(list(getattr(agent, model).parameters()), algo[group]["optimizer"], algo[group]["clip_gradients"])
        for key, (model, group) in groups.items()
    }


def ensemble_loss(ensemble: nn.Module, inputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each member predicts the step after from ``inputs [T, B, in]``
    (``target [T-1, B, D]``): the sum over members of each member's mean
    ``Normal(pred, 1)`` negative log-likelihood."""
    outs = ensemble(inputs)[:, :-1]
    return -Independent(Normal(outs, torch.ones_like(outs)), 1).log_prob(target.expand_as(outs)).mean((1, 2)).sum()


def critic_loss(critic: nn.Module, trajectories: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """A critic's discounted ``Normal(v, 1)`` negative log-likelihood of
    the detached targets on the detached imagination (JAX :274-283)."""
    qv = critic(trajectories[:-1].detach())
    return -torch.mean(discount[:-1][..., 0] * Independent(Normal(qv, torch.ones_like(qv)), 1).log_prob(lambda_values.detach()))


def make_train_step(agent: P2EDV2Agent, opts: Mapping[str, Adam], cfg: Dict[str, Any], is_continuous: bool):
    """One exploration gradient step over a time-major ``[T, B]`` batch.

    Returns ``train_step(data, generator=None, grads_out=None) ->
    metrics [22]`` (``METRIC_ORDER``): it updates every trained model and
    optimizer in place. ``grads_out``, a dict, receives each model's
    gradients before clipping, keyed by the models' checkpoint keys."""
    algo = cfg["algo"]
    horizon, gamma, lmbda = int(algo["horizon"]), float(algo["gamma"]), float(algo["lmbda"])
    ent_coef = float(algo["actor"]["ent_coef"])
    use_continues = bool(algo["world_model"]["use_continues"])
    multiplier = float(algo["intrinsic_reward_multiplier"])
    wm, ensemble = agent.world_model, agent.ensembles

    def behaviour(actor, target_critic, start, reward_fn, generator):
        """The Dreamer-V2 behaviour objective of P2E (JAX :265-330):
        ``(policy_loss, trajectories, lambda_values, discount, target
        values, reward)``."""
        start_z, start_h, true_continue = start
        with torch.set_grad_enabled(is_continuous):
            trajectories, actions = dv2.imagine(wm, actor, start_z, start_h, horizon, generator)
            target_values = target_critic(trajectories)
            reward = reward_fn(trajectories, actions)
            if use_continues:
                continues = torch.cat([true_continue, torch.sigmoid(wm.continue_logits(trajectories))[1:]], 0)
            else:
                continues = torch.ones_like(reward) * gamma
            lambda_values = compute_lambda_values_bootstrap(
                reward[:-1], target_values[:-1], continues[:-1], bootstrap=target_values[-1:], lmbda=lmbda
            )
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()
        logp, entropy = actor_logprob_entropy(actor, trajectories[:-2].detach(), actions[1:-1].detach())
        if is_continuous:
            objective = lambda_values[1:]
        else:
            objective = logp[..., None] * (lambda_values[1:] - target_values[:-2]).detach()
        policy_loss = -torch.mean(discount[:-2] * (objective + ent_coef * entropy[..., None]))
        return policy_loss, trajectories, lambda_values, discount, target_values, reward

    def train_step(
        data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, grads_out: Optional[Dict[str, List[torch.Tensor]]] = None
    ) -> torch.Tensor:
        T, B = data["rewards"].shape[:2]
        # 1. the world model
        hs, zs, wm_metrics, wm_gnorm, wm_grads = dv2.world_model_step(wm, opts["world_optimizer"], data, cfg, generator, detach_heads=True)
        # 2. the ensemble, in posterior space
        ens_loss = ensemble_loss(ensemble, torch.cat([zs.detach(), hs.detach(), data["actions"]], -1), zs.detach()[1:])
        ens_grads = _grads(ens_loss, list(ensemble.parameters()))
        ens_gnorm = opts["ensemble_optimizer"].step(ens_grads)
        start = (zs.detach().reshape(T * B, -1), hs.detach().reshape(T * B, -1), (1 - data["terminated"]).reshape(1, T * B, 1) * gamma)

        # 3. the exploration actor on the disagreement, 4. its critic
        expl_loss, expl_traj, expl_lambda, expl_discount, expl_values, intrinsic = behaviour(
            agent.actor_exploration,
            agent.target_critic_exploration,
            start,
            lambda trajectories, actions: intrinsic_reward(ensemble, trajectories, actions, multiplier),
            generator,
        )
        expl_grads = _grads(expl_loss, list(agent.actor_exploration.parameters()))
        expl_gnorm = opts["actor_exploration_optimizer"].step(expl_grads)
        value_loss_expl = critic_loss(agent.critic_exploration, expl_traj, expl_lambda, expl_discount)
        critic_expl_grads = _grads(value_loss_expl, list(agent.critic_exploration.parameters()))
        critic_expl_gnorm = opts["critic_exploration_optimizer"].step(critic_expl_grads)

        # 5. the task actor and critic (zero-shot)
        task_loss, task_traj, task_lambda, task_discount, _, _ = behaviour(
            agent.actor_task, agent.target_critic_task, start, lambda trajectories, actions: wm.reward_mean(trajectories), generator
        )
        task_grads = _grads(task_loss, list(agent.actor_task.parameters()))
        task_gnorm = opts["actor_task_optimizer"].step(task_grads)
        value_loss_task = critic_loss(agent.critic_task, task_traj, task_lambda, task_discount)
        critic_task_grads = _grads(value_loss_task, list(agent.critic_task.parameters()))
        critic_task_gnorm = opts["critic_task_optimizer"].step(critic_task_grads)

        if grads_out is not None:
            grads_out.update(
                world_model=wm_grads,
                ensembles=ens_grads,
                actor_exploration=expl_grads,
                critic_exploration=critic_expl_grads,
                actor_task=task_grads,
                critic_task=critic_task_grads,
            )
        return torch.stack(
            [
                *wm_metrics,
                ens_loss,
                expl_loss,
                value_loss_expl,
                task_loss,
                value_loss_task,
                intrinsic.mean(),
                expl_values.detach().mean(),
                expl_lambda.detach().mean(),
                wm_gnorm,
                ens_gnorm,
                expl_gnorm,
                critic_expl_gnorm,
                task_gnorm,
                critic_task_gnorm,
            ]
        ).detach()

    return train_step


TRAINED = ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task")


def make_train_fn(train_step: Callable, agent: Any, opts: Mapping[str, Adam], inputs: Dict[str, torch.Tensor], generator: Optional[torch.Generator]) -> CapturedStep:
    """``train_step`` over the static batch ``inputs`` as a
    ``CapturedStep``: replayed from one CUDA graph on the card, eager on the
    CPU; it updates every trained model and optimizer in place."""
    state = [p for k in TRAINED for p in getattr(agent, k).parameters()]
    for opt in opts.values():
        state += opt.state_tensors()
    return CapturedStep(lambda data: train_step(data, generator), inputs, state, generator)


def refresh_targets(agent: P2EDV2Agent) -> None:
    """The task and the exploration target critics := their critics."""
    hard_copy_(agent.critic_task, agent.target_critic_task)
    hard_copy_(agent.critic_exploration, agent.target_critic_exploration)


def exploration_main(
    fabric: Any,
    cfg: Optional[Dict[str, Any]],
    device: DeviceLike,
    build: Callable[..., Any],
    make_step: Callable[..., Callable],
    refresh: Optional[Callable[[Any], None]],
) -> Dict[str, Any]:
    """The exploration ``main`` of P2E over Dreamer-V1 or V2 (JAX
    ``p2e_dv2_exploration.py:386-814``, ``p2e_dv1_exploration.py`` alike):
    ``build`` the agent, ``make_step(agent, opts, cfg, is_continuous)`` its
    train step, ``refresh(agent)`` its target critics before the steps
    0, freq, 2 freq, ... (none without one). Returns the run's counts,
    seconds and metrics."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg, buffer_cfg = cfg["algo"], cfg["checkpoint"], cfg["buffer"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    state = load_checkpoint(resume_from) if resume_from else None
    # these arguments cannot be changed (JAX :391-393)
    cfg["env"]["screen_size"] = 64
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

    agent = build(actions_dim, is_continuous, cfg, obs_space, device=dev)
    models = models_of(agent)
    opts = build_optimizers(cfg, agent)
    if state is not None:
        load_checkpoint_state(state, models, opts)
    train_step = make_step(agent, opts, cfg, is_continuous)
    player = place_dreamer_player(agent.player, cfg, dev)
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state, state if buffer_cfg["checkpoint"] else None, player.device)
    rb, ratio = ls.rb, ls.ratio
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        return {
            **checkpoint_state(models, opts),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": ls.batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
        }

    aggregator = build_aggregator(cfg, set(METRIC_ORDER) | {"Rewards/rew_avg", "Game/ep_len_avg", "Params/exploration_amount"})
    env_loop = EnvLoopDV2(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed), close_first_in_dry_run=False)
    env_loop.reset(seed)
    trainer = ReplayTrainer(
        cfg,
        rb,
        ls.batch_size,
        lambda inputs: make_train_fn(train_step, agent, opts, inputs, ls.train_gen),
        None if refresh is None else (lambda tau: refresh(agent)),
        dev,
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
                # a placed player's copy lands at a later action (JAX :724-725)
                player.stream_params()
                if log_level > 0:
                    aggregator.update("Params/exploration_amount", agent.actor_task.get_expl_amount(policy_step))
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
    # the task actor's zero-shot test (JAX :810-812)
    player.flush_params()
    test_reward, test_steps = None, 0
    if algo.get("run_test", False):
        player.actor = agent.actor_task
        test_reward, test_steps = test(player, cfg, log_dir, "zero-shot", greedy=False, logger=logger)
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
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Explore with Plan2Explore on Dreamer-V2, called as the CLI calls it,
    ``main(fabric, cfg)``, or as ``main(cfg, device=...)`` (the CUDA card
    unless ``device="cpu"``), for ``algo.total_steps`` env steps: uniform
    random actions up to ``algo.learning_starts`` on a fresh run, then the
    exploration actor; ``Ratio``'s gradient steps with both target critics
    hard-copied every ``per_rank_target_network_update_freq`` steps."""
    return exploration_main(fabric, cfg, device, build_agent, make_train_step, refresh_targets)

