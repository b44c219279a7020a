"""Plan2Explore on Dreamer-V3, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py:43-449``).

``main`` loads the exploration checkpoint (or ``checkpoint.resume_from``),
forces the model keys to the exploration run's values, and trains the task
models with Dreamer-V3's captured train step (``dreamer_v3.make_train_step``
and ``make_train_fn``) in Dreamer-V3's host loop. The player acts with the
exploration actor until the first gradient step, then with the task actor:
the player runs eagerly and reads ``player.actor`` at every step, so the
switch is one assignment. Checkpoints are in the JAX layout (Dreamer-V3's
keys named as P2E stores them, ``convert.TASK_KEYS``, and the exploration
actor); the few-shot test of the task actor ends the run.

``exploration_config`` is the finetuning handling of the JAX CLI
(``sheeprl_tpu/cli.py:137-167``): the exploration run's ``config.yaml``,
read with the port's own reader, and its env keys forced onto this run.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_critic, init_weights, make_actor
from sheeprl_tpu_torch.algos.dreamer_v3.convert import actor_from_flax, actor_to_flax
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import EnvLoop, LogWindows, ReplayTrainer, ema_, loop_state, place_dreamer_player, replay_kind, resolve_fabric
from sheeprl_tpu_torch.algos.p2e_dv3.convert import TASK_KEYS
from sheeprl_tpu_torch.algos.p2e_dv3.utils import AGGREGATOR_KEYS_FINETUNING, test
from sheeprl_tpu_torch.config.compose import load_config_file
from sheeprl_tpu_torch.device import DeviceLike, compute_dtype
from sheeprl_tpu_torch.envs.factory import build_vector_env
from sheeprl_tpu_torch.envs.spaces import action_dims
from sheeprl_tpu_torch.obs.telemetry import telemetry_advance
from sheeprl_tpu_torch.ops.math import init_moments
from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events, resolve_auto_resume
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import build_aggregator
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import dotdict, save_configs

# the model keys that must match the exploration run (JAX :52-65)
FORCED_ALGO_KEYS = (
    "gamma",
    "lmbda",
    "horizon",
    "dense_units",
    "mlp_layers",
    "unimix",
    "hafner_initialization",
    "world_model",
    "actor",
    "critic",
    "cnn_keys",
    "mlp_keys",
)
# the env keys the CLI forces from the exploration run (JAX cli.py:153-164)
FORCED_ENV_KEYS = (
    "frame_stack",
    "screen_size",
    "action_repeat",
    "grayscale",
    "clip_rewards",
    "frame_stack_dilation",
    "max_episode_steps",
    "reward_as_observation",
)


def exploration_config(cfg: Dict[str, Any]) -> dotdict:
    """The config of the exploration run that wrote
    ``checkpoint.exploration_ckpt_path`` (its ``config.yaml``, JSON or YAML,
    beside ``<version dir>/checkpoint``); raises for another ``env.id``,
    and forces the eight env keys of ``FORCED_ENV_KEYS`` onto ``cfg``."""
    ckpt_path = cfg["checkpoint"].get("exploration_ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise ValueError("checkpoint.exploration_ckpt_path must be set for P2E finetuning")
    path = os.path.join(os.path.dirname(os.path.dirname(ckpt_path)), "config.yaml")
    exploration_cfg = load_config_file(path)
    if exploration_cfg["env"]["id"] != cfg["env"]["id"]:
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want to "
            f"finetune. Got '{cfg['env']['id']}', but the environment used during exploration was "
            f"{exploration_cfg['env']['id']}."
        )
    for k in FORCED_ENV_KEYS:
        if k in exploration_cfg["env"]:
            cfg["env"][k] = exploration_cfg["env"][k]
    return exploration_cfg


def task_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A P2E checkpoint's task models, optimizers and Moments under
    Dreamer-V3's keys (``dreamer_v3.load_checkpoint_state``'s input)."""
    return {dv3_key: state[key] for dv3_key, key in TASK_KEYS.items()}


@register_algorithm()
def main(
    fabric: Any,
    cfg: Optional[Dict[str, Any]] = None,
    *,
    exploration_cfg: Mapping[str, Any],
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Finetune the task models of an exploration run, called as the CLI
    calls it, ``main(fabric, cfg, exploration_cfg=...)``, or as ``main(cfg,
    exploration_cfg=..., device=...)`` (the CUDA card unless
    ``device="cpu"``), for ``algo.total_steps`` env steps;
    ``exploration_cfg`` is :func:`exploration_config` of ``cfg``, which the
    CLI reads. Returns the run's counts, seconds and metrics, and
    ``switched_at``, the policy step whose action the task actor took
    first."""
    fabric, cfg, callback = resolve_fabric(fabric, cfg, device)
    dev = fabric.device
    algo, ckpt_cfg = cfg["algo"], cfg["checkpoint"]
    seed = int(cfg["seed"])
    resume_from = ckpt_cfg["resume_from"]
    if resume_from == "auto":
        resume_from = resolve_auto_resume(cfg)
        emit_pending_resilience_events()
    resuming = bool(resume_from)
    state = load_checkpoint(resume_from if resuming else ckpt_cfg["exploration_ckpt_path"])
    # the model must be the exploration run's (JAX :50-71)
    for k in FORCED_ALGO_KEYS:
        if k in exploration_cfg["algo"]:
            algo[k] = exploration_cfg["algo"][k]
    cfg["env"]["clip_rewards"] = exploration_cfg["env"]["clip_rewards"]
    buffer_cfg = cfg["buffer"]
    load_buffer = bool(buffer_cfg.get("load_from_exploration")) and bool(exploration_cfg["buffer"]["checkpoint"])
    if load_buffer:
        cfg["env"]["num_envs"] = exploration_cfg["env"]["num_envs"]
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

    wm, actor_task, player = build_agent(actions_dim, is_continuous, cfg, obs_space, device=dev)
    critic, target_critic = build_critic(cfg, wm.latent_state_size, device=dev)
    actor_exploration = make_actor(cfg, wm.latent_state_size, actions_dim, is_continuous, compute_dtype(cfg["fabric"]["precision"]))
    init_weights(actor_exploration, torch.Generator().manual_seed(seed + 2))
    actor_exploration.to(dev).eval()
    opts = dv3.build_optimizers(cfg, wm, actor_task, critic)
    moments = init_moments(dev)
    dv3.load_checkpoint_state(task_state(state), wm, actor_task, critic, target_critic, opts, moments)
    actor_exploration.load_state_dict(actor_from_flax(state["actor_exploration"]))
    train_step = dv3.make_train_step(wm, actor_task, critic, target_critic, *opts, cfg, is_continuous)
    aggregator = build_aggregator(cfg, AGGREGATOR_KEYS_FINETUNING)

    # a resumed run keeps its counters; the buffer comes from the resumed
    # checkpoint (buffer.checkpoint) or the exploration one (JAX :159-170)
    restore = (resuming and buffer_cfg["checkpoint"]) or load_buffer
    place_dreamer_player(player, cfg, dev)
    ls = loop_state(cfg, dev, obs_space, actions_dim, log_dir, state if resuming else None, state if restore else None, player.device)
    rb, ratio = ls.rb, ls.ratio
    policy_step, last_log, last_checkpoint = ls.policy_step, ls.last_log, ls.last_checkpoint

    def ckpt_state_fn(completed_update: int) -> Dict[str, Any]:
        task = dv3.checkpoint_state(wm, actor_task, critic, target_critic, opts, moments)
        return {
            **{TASK_KEYS[k]: v for k, v in task.items()},
            "actor_exploration": actor_to_flax(actor_exploration.state_dict()),
            "ratio": ratio.state_dict(),
            "update": completed_update,
            "batch_size": ls.batch_size,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "rng_key": ls.train_gen.get_state().numpy(),
            "player_rng_key": ls.player_gen.get_state().numpy(),
        }

    env_loop = EnvLoop(envs, rb, player, cfg, aggregator, ls.player_gen, np.random.default_rng(seed))
    env_loop.reset(seed)
    trainer = ReplayTrainer(
        cfg,
        rb,
        ls.batch_size,
        lambda inputs: dv3.make_train_fn(train_step, wm, actor_task, critic, opts, moments, inputs, ls.train_gen),
        lambda tau: ema_(critic, target_critic, tau),
        dev,
    )
    logs = LogWindows(cfg, logger, aggregator, dv3.METRIC_ORDER, last_log)
    # the exploration actor plays until the first gradient step (JAX :225-228)
    player.actor = actor_exploration
    switched_at: Optional[int] = None
    t_start = time.perf_counter()
    try:
        for update in range(ls.start_step, ls.num_updates + 1):
            telemetry_advance(policy_step)
            policy_step += num_envs
            env_loop.step(random=False)
            n_steps = ratio(policy_step) if update >= ls.learning_starts else 0
            if n_steps > 0:
                if switched_at is None:
                    # the task actor acts from the next env step on (JAX :320-323)
                    player.actor = actor_task
                    switched_at = policy_step + num_envs
                trainer.window(n_steps)
                player.stream_params()
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
    # the task actor's few-shot test (JAX :446-448)
    test_reward, test_steps = None, 0
    player.flush_params()
    if algo.get("run_test", False):
        player.actor = actor_task
        test_reward, test_steps = test(player, cfg, log_dir, "few-shot", greedy=False, logger=logger)
    logger.finalize()
    return {
        "log_dir": log_dir,
        "start_update": ls.start_step,
        "env_steps": policy_step,
        "switched_at": switched_at,
        "seconds": seconds,
        "log": logs.logged,
        "moments": (float(moments.low), float(moments.high)),
        "last_checkpoint": last_checkpoint,
        **trainer.report(dv3.METRIC_ORDER),
        "replay_buffer": replay_kind(rb),
        "test_cumulative_reward": test_reward,
        "test_steps": test_steps,
    }
