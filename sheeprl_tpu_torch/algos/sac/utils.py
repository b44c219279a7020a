"""SAC helpers (port of ``sheeprl_tpu/algos/sac/utils.py``: ``AGGREGATOR_KEYS``,
``prepare_obs`` and the greedy ``test`` episode)."""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.utils.model_manager import make_log_models

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}


def prepare_obs(obs: Mapping[str, np.ndarray], mlp_keys: Sequence[str] = (), num_envs: int = 1) -> np.ndarray:
    """The vector keys concatenated to ``[num_envs, obs_dim]`` float32 (JAX
    :21-28)."""
    return np.concatenate([np.asarray(obs[k], np.float32) for k in mlp_keys], axis=-1).reshape(num_envs, -1)


def test(
    player: Any,
    cfg: Mapping[str, Any],
    prepare: Callable[[Mapping[str, np.ndarray]], Any],
    log_dir: Optional[str] = None,
    logger: Any = None,
) -> Tuple[float, int]:
    """One greedy episode on a fresh env built by ``make_env`` (JAX
    :34-51), ``prepare`` turning each observation into the player's input;
    returns its reward sum and its number of steps and logs the sum as
    ``Test/cumulative_reward`` when ``metric.log_level`` > 0."""
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test", vector_env_idx=0)()
    done = False
    cumulative_rew = 0.0
    steps = 0
    obs, _ = env.reset(seed=cfg["seed"])
    while not done:
        action = player.get_actions(prepare(obs), greedy=True)
        obs, reward, terminated, truncated, _ = env.step(np.asarray(action).reshape(env.action_space.shape))
        done = terminated or truncated or cfg["dry_run"]
        cumulative_rew += float(reward)
        steps += 1
    print(f"Test - Reward: {cumulative_rew}")
    if logger is not None and int(cfg["metric"]["log_level"]) > 0:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew, steps


# the sub-models cli_registration registers from a checkpoint
MODELS_TO_REGISTER = {"agent"}
log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
