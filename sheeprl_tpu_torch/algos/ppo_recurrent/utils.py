"""Recurrent PPO helpers (port of ``sheeprl_tpu/algos/ppo_recurrent/utils.py``:
``AGGREGATOR_KEYS`` and ``test``, the greedy episode with the LSTM state
carried through it)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action
from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, prepare_obs  # noqa: F401  (the recurrent PPO API)
from sheeprl_tpu_torch.envs.factory import make_env


def test(player: Any, cfg: Mapping[str, Any], log_dir: Optional[str] = None, logger: Any = None) -> Tuple[float, int]:
    """One greedy episode on a fresh env built by ``make_env`` (JAX
    ``utils.py:25-62``), ``hx``/``cx`` and the previous actions carried from
    step to step from zeros; returns its reward sum and its number of steps
    and logs the sum as ``Test/cumulative_reward`` through ``logger`` when
    ``metric.log_level`` > 0."""
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test", vector_env_idx=0)()
    agent = player.agent
    dev = player.device
    done = False
    cumulative_rew = 0.0
    steps = 0
    obs, _ = env.reset(seed=cfg["seed"])
    hx = torch.zeros(1, agent.lstm_hidden_size, device=dev)
    cx = torch.zeros(1, agent.lstm_hidden_size, device=dev)
    prev_actions = torch.zeros(1, sum(agent.actions_dim), device=dev)
    cnn_keys = cfg["algo"]["cnn_keys"]["encoder"]
    while not done:
        actions, _, _, hx, cx = player.get_actions(prepare_obs(obs, cnn_keys=cnn_keys), prev_actions, hx, cx, greedy=True)
        prev_actions = actions
        real = env_action(actions[0].cpu().numpy(), agent.actions_dim, agent.is_continuous)
        obs, reward, terminated, truncated, _ = env.step(real)
        done = terminated or truncated or cfg["dry_run"]
        cumulative_rew += float(reward)
        steps += 1
    print(f"Test - Reward: {cumulative_rew}")
    if logger is not None and int(cfg["metric"]["log_level"]) > 0:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew, steps
