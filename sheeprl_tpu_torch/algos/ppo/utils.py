"""PPO helpers (port of ``sheeprl_tpu/algos/ppo/utils.py``:
``AGGREGATOR_KEYS``, ``prepare_obs``, ``test`` and ``normalize_obs``)."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action
from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.utils.model_manager import make_log_models

# the metrics the loop produces: the CLI keeps only these of the composed
# aggregator, and ``main`` adds a mean for each one it lacks
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}


def prepare_obs(obs: Mapping[str, np.ndarray], cnn_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """[E, ...] obs dict for the agent: a frame stack folds into channels
    (``[E, S, H, W, C] -> [E, H, W, S*C]``), pixels stay ``uint8`` (the
    agent scales them on the device), vectors become float32 with a
    leading batch axis."""
    out: Dict[str, np.ndarray] = {}
    for k, v in obs.items():
        v = np.asarray(v)
        if k in cnn_keys:
            if v.ndim == 3:
                v = v[None]
            if v.ndim == 4 and v.shape[0] != num_envs:
                v = v[None]
            if v.ndim == 5:
                e, s, h, w, c = v.shape
                v = np.moveaxis(v, 1, 3).reshape(e, h, w, s * c)
        else:
            if v.ndim == 1:
                v = v[None]
            v = v.astype(np.float32)
        out[k] = v
    return out


def normalize_obs(obs: Mapping[str, Any], cnn_keys: Sequence[str], obs_keys: Sequence[str]) -> Dict[str, Any]:
    """The observation keys the agent reads; pixels are scaled inside the
    agent, so nothing else happens here (as in the JAX package)."""
    return {k: obs[k] for k in obs_keys}


def test(player: Any, cfg: Mapping[str, Any], log_dir: Optional[str] = None, logger: Any = None) -> Tuple[float, int]:
    """One greedy episode on a fresh env built by ``make_env`` (JAX
    ``utils.py:48-79``); returns its reward sum and its number of steps and
    logs the sum as ``Test/cumulative_reward`` through ``logger`` when
    ``metric.log_level`` > 0."""
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test", vector_env_idx=0)()
    done = False
    cumulative_rew = 0.0
    steps = 0
    cnn_keys = cfg["algo"]["cnn_keys"]["encoder"]
    obs, _ = env.reset(seed=cfg["seed"])
    generator = torch.Generator(device=player.device).manual_seed(int(cfg["seed"]))
    agent = player.agent
    while not done:
        actions, _, _ = player.get_actions(prepare_obs(obs, cnn_keys=cnn_keys), generator, greedy=True)
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


# the sub-models cli_registration registers from a checkpoint
MODELS_TO_REGISTER = {"agent"}
log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
