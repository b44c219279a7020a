"""Dreamer-V3 helpers (port of ``sheeprl_tpu/algos/dreamer_v3/utils.py``:
``AGGREGATOR_KEYS`` :18-34, ``prepare_obs`` :36-58 and ``test`` :61-103)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.factory import make_env
from sheeprl_tpu_torch.utils.model_manager import make_log_models

# the metrics the loop produces: the CLI keeps only these of the composed
# aggregator, and ``main`` adds a mean for each one it lacks
AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """[E, ...] obs dict for the player: frame stacks fold into channels,
    pixels stay uint8 (the encoder normalises them on the device)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in obs.items():
        v = np.asarray(v)
        if k in cnn_keys:
            if v.ndim == 3:
                v = v[None]
            if v.ndim == 4 and v.shape[0] != num_envs:
                v = v[None]
            if v.ndim == 5:  # [E,S,H,W,C] -> [E,H,W,S*C]
                e, s, h, w, c = v.shape
                v = np.moveaxis(v, 1, 3).reshape(e, h, w, s * c)
        else:
            v = v.reshape(num_envs, -1).astype(np.float32)
        out[k] = v
    return out


def env_action(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> Any:
    """The env's action from the player's row ``actions`` [A]: the vector
    itself when continuous, else the argmax of each one-hot part."""
    if is_continuous:
        return actions
    splits = np.cumsum(actions_dim)[:-1]
    real = np.array([p.argmax(-1) for p in np.split(actions, splits, axis=-1)])
    return real[0] if len(real) == 1 else real


def test(
    player: Any,
    cfg: Dict[str, Any],
    log_dir: Optional[str] = None,
    test_name: str = "",
    greedy: bool = True,
    logger: Any = None,
) -> Tuple[float, int]:
    """One frozen-policy episode on a fresh env, built by ``make_env`` as
    for training (JAX ``utils.py:61-103``); returns its reward sum and its
    number of steps, and logs the sum as ``Test/cumulative_reward``
    through ``logger`` when ``metric.log_level`` > 0."""
    env = make_env(cfg, cfg["seed"], 0, log_dir, "test" + (f"_{test_name}" if test_name else ""))()
    done = False
    cumulative_rew = 0.0
    steps = 0
    obs, _ = env.reset(seed=cfg["seed"])
    saved_num_envs = player.num_envs
    player.num_envs = 1
    player.init_states()
    generator = torch.Generator(device=player.device).manual_seed(int(cfg["seed"]))
    cnn_keys = cfg["algo"]["cnn_keys"]["encoder"]
    while not done:
        actions = player.get_actions(prepare_obs(obs, cnn_keys=cnn_keys), generator, greedy=greedy)
        real = env_action(actions[0], player.actions_dim, player.actor.is_continuous)
        obs, reward, terminated, truncated, _ = env.step(np.asarray(real).reshape(env.action_space.shape))
        done = terminated or truncated or cfg["dry_run"]
        cumulative_rew += float(reward)
        steps += 1
    print(f"Test - Reward: {cumulative_rew}")
    if logger is not None and int(cfg["metric"]["log_level"]) > 0:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    player.num_envs = saved_num_envs
    env.close()
    return cumulative_rew, steps


# the sub-models cli_registration registers from a checkpoint
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}
log_models_from_checkpoint = make_log_models(MODELS_TO_REGISTER)
