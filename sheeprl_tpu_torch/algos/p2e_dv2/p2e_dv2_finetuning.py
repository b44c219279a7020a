"""Plan2Explore on Dreamer-V2, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py:57-446``).

:func:`finetuning_main`, shared with P2E over Dreamer-V1, loads the
exploration checkpoint (or ``checkpoint.resume_from``), forces the model
keys to the exploration run's values, and trains the task models with the
plain Dreamer step (Dreamer-V2's ``make_train_step`` here, the target
critic hard-copied every ``per_rank_target_network_update_freq`` steps)
replayed from one CUDA graph, in Dreamer-V2's env loop. The player acts
with the exploration actor (with its exploration noise) until the first
gradient step, then with the task actor: the player reads ``player.actor``
at every step, so the switch is one assignment. Checkpoints hold the JAX
keys (the task models, their optimizers and the exploration actor); the
few-shot test of the task actor ends the run. The CLI passes the
exploration run's config (``p2e_dv3_finetuning.exploration_config``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import EnvLoopDV2, hard_copy_
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import LogWindows, ReplayTrainer, build_optimizers, loop_state, place_dreamer_player, replay_kind, resolve_fabric
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.convert import checkpoint_state, load_checkpoint_state
from sheeprl_tpu_torch.algos.p2e_dv2.utils import test
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import exploration_config  # noqa: F401  (the CLI reads it here)
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import save_configs

# the model keys that must match the exploration run (JAX :64-79)
FORCED_ALGO_KEYS = (
    "gamma",
    "lmbda",
    "horizon",
    "layer_norm",
    "dense_units",
    "mlp_layers",
    "dense_act",
    "cnn_act",
    "world_model",
    "actor",
    "critic",
    "cnn_keys",
    "mlp_keys",
)
OPTIMIZER_KEYS = ("world_optimizer", "actor_task_optimizer", "critic_task_optimizer")


def finetuning_main(
    fabric: Any,
    cfg: Optional[Dict[str, Any]],
    device: DeviceLike,
    exploration_cfg: Mapping[str, Any],
    build: Callable[..., Any],
    task_step: Callable[..., Callable],
    refresh: Optional[Callable[[Any], None]],
    forced_keys: Sequence[str],
    metric_order: Sequence[str],
) -> Dict[str, Any]:
    """The finetuning ``main`` of P2E over Dreamer-V1 or V2: ``build`` the
    P2E agent, load its task models (the target critic where it has one)
    and exploration actor and the task optimizers from the checkpoint,
    ``task_step(agent, opts, cfg)`` the Dreamer train step over them,
    ``refresh(agent)`` the target critic (none without one). Returns the
    run's counts, seconds and metrics, and ``switched_at``, the policy step
    whose action the task actor took first."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg, buffer_cfg = cfg["algo"], cfg["checkpoint"], cfg["buffer"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    resuming = bool(resume_from)
    state = load_checkpoint(resume_from if resuming else ckpt_cfg["exploration_ckpt_path"])
    # the model must be the exploration run's (JAX :62-83)
    for k in forced_keys:
        if k in exploration_cfg["algo"]:
            algo[k] = exploration_cfg["algo"][k]
    cfg["env"]["clip_rewards"] = exploration_cfg["env"]["clip_rewards"]
    load_buffer = bool(buffer_cfg.get("load_from_exploration")) and bool(exploration_cfg["buffer"]["checkpoint"])
    if load_buffer:
        cfg["env"]["num_envs"] = exploration_cfg["env"]["num_envs"]
    cfg["env"]["screen_size"] = 64
    cfg["env"]["frame_stack"] = 1
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
    keys = ["world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration"]
    models = {k: getattr(agent, k) for k in keys if hasattr(agent, k)}
    opts = dict(zip(OPTIMIZER_KEYS, build_optimizers(cfg, agent.world_model, agent.actor_task, agent.critic_task)))
    load_checkpoint_state(state, models, opts)
    train_step = task_step(agent, tuple(opts.values()), cfg)
    aggregator = build_aggregator(cfg, set(metric_order) | {"Rewards/rew_avg", "Game/ep_len_avg", "Params/exploration_amount"})

    # a resumed run keeps its counters; the buffer comes from the resumed
    # checkpoint (buffer.checkpoint) or the exploration one (JAX :159-170)
    restore = (resuming and buffer_cfg["checkpoint"]) or load_buffer
    player = place_dreamer_player(agent.player, cfg, dev)
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state if resuming else None, state if restore else None, player.device)
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

    env_loop = EnvLoopDV2(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed), close_first_in_dry_run=False)
    env_loop.reset(seed)
    trainer = ReplayTrainer(
        cfg,
        rb,
        ls.batch_size,
        lambda inputs: dv2.make_train_fn(train_step, agent.world_model, agent.actor_task, agent.critic_task, tuple(opts.values()), inputs, ls.train_gen),
        None if refresh is None else (lambda tau: refresh(agent)),
        dev,
    )
    logs = LogWindows(cfg, logger, aggregator, metric_order, last_log)
    log_level = int(cfg["metric"]["log_level"])
    # the exploration actor plays until the first gradient step (JAX :225-228)
    player.actor = agent.actor_exploration
    switched_at: Optional[int] = None
    update_seconds: List[float] = []
    t_start = t_update = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            policy_step += num_envs
            env_loop.step(random=False, policy_step=policy_step)
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0:
                if switched_at is None:
                    # the task actor acts from the next env step on (JAX :328-331)
                    player.actor = agent.actor_task
                    switched_at = policy_step + num_envs
                trainer.window(n_steps)
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
    # the task actor's few-shot test (JAX :442-444)
    player.flush_params()
    test_reward, test_steps = None, 0
    if algo.get("run_test", False):
        player.actor = agent.actor_task
        test_reward, test_steps = test(player, cfg, log_dir, "few-shot", greedy=False, logger=logger)
    logger.finalize()
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "switched_at": switched_at,
        "seconds": seconds,
        "update_seconds": update_seconds,
        "log": logs.logged,
        "last_checkpoint": last_checkpoint,
        **trainer.report(metric_order),
        "replay_buffer": replay_kind(rb),
        "player_device": str(player.device),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }


def task_step(agent: Any, opts: Sequence[Any], cfg: Dict[str, Any]) -> Callable:
    """Dreamer-V2's train step over the task models."""
    return dv2.make_train_step(agent.world_model, agent.actor_task, agent.critic_task, agent.target_critic_task, *opts, cfg)


@register_algorithm()
def main(
    fabric: Any,
    cfg: Optional[Dict[str, Any]] = None,
    *,
    exploration_cfg: Mapping[str, Any],
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Finetune the task models of a P2E-DV2 exploration run, called as the
    CLI calls it, ``main(fabric, cfg, exploration_cfg=...)``, or as
    ``main(cfg, exploration_cfg=..., device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps."""
    return finetuning_main(
        fabric,
        cfg,
        device,
        exploration_cfg,
        build_agent,
        task_step,
        lambda agent: hard_copy_(agent.critic_task, agent.target_critic_task),
        FORCED_ALGO_KEYS,
        dv2.METRIC_ORDER,
    )
