"""Dreamer-V1's world-model loss (port of
``sheeprl_tpu/algos/dreamer_v1/loss.py:20-52``): ``KL(Normal(post) ||
Normal(prior))`` held at ``kl_free_nats`` from below, no KL balancing."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.distributions import Independent, Normal, kl_divergence


def reconstruction_loss(
    qo: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    qr: Any,
    rewards: torch.Tensor,
    post_mean: torch.Tensor,
    post_std: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_std: torch.Tensor,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, ...]:
    """The observation and reward (``Normal(mean, 1)``) and optional
    continue (Bernoulli) negative log-likelihoods plus ``kl_regularizer *
    max(KL(post || prior), kl_free_nats)``. Returns ``(loss, kl,
    state_loss, reward_loss, observation_loss, continue_loss)``."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo.keys())
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(Independent(Normal(post_mean, post_std), 1), Independent(Normal(prior_mean, prior_std), 1)).mean()
    # clamp_min is jnp.maximum against the constant (no host tensor: a
    # captured step may not copy one across)
    state_loss = kl.clamp_min(kl_free_nats)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return total, kl, state_loss, reward_loss, observation_loss, continue_loss
