"""Shared Plan2Explore constants (port of ``sheeprl_tpu/algos/p2e_common.py``
:15-48).

All three P2E generations log the same exploration metric surface; each
version's ``utils.py`` keeps only its deltas. Their registration hooks
come from ``utils/model_manager.py::make_log_models``, as every ported
algorithm's do.
"""

from __future__ import annotations

# the exploration-phase metric names common to P2E DV1/DV2/DV3
P2E_EXPLORATION_KEYS = frozenset(
    {
        "Rewards/rew_avg",
        "Game/ep_len_avg",
        "Loss/world_model_loss",
        "Loss/value_loss_task",
        "Loss/policy_loss_task",
        "Loss/value_loss_exploration",
        "Loss/policy_loss_exploration",
        "Loss/observation_loss",
        "Loss/reward_loss",
        "Loss/state_loss",
        "Loss/continue_loss",
        "Loss/ensemble_loss",
        "State/kl",
        "State/post_entropy",
        "State/prior_entropy",
        "Params/exploration_amount",
        "Rewards/intrinsic",
        "Values_exploration/predicted_values",
        "Values_exploration/lambda_values",
        "Grads/world_model",
        "Grads/actor_task",
        "Grads/critic_task",
        "Grads/actor_exploration",
        "Grads/critic_exploration",
        "Grads/ensemble",
    }
)

# the plain Dreamer metric names the finetuning phase logs on top
DREAMER_FINETUNING_KEYS = frozenset({"Loss/value_loss", "Loss/policy_loss", "Grads/actor", "Grads/critic"})
