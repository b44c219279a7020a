"""Dreamer-V2's world-model loss with KL balancing (port of
``sheeprl_tpu/algos/dreamer_v2/loss.py:20-71``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.distributions import Independent, OneHotCategoricalStraightThrough, kl_divergence


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """The observation and reward (and continue) negative log-likelihoods
    plus ``kl_regularizer`` times the balanced KL term
    ``alpha * KL(sg(post) || prior) + (1 - alpha) * KL(post || sg(prior))``,
    each side held at ``kl_free_nats`` from below, after the mean with
    ``kl_free_avg`` and per element before it otherwise. The logits are
    ``[T, B, S, D]``. Returns ``(loss, kl, kl_loss, reward_loss,
    observation_loss, continue_loss)``."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po.keys())
    reward_loss = -pr.log_prob(rewards).mean()

    def dist(logits: torch.Tensor) -> Independent:
        return Independent(OneHotCategoricalStraightThrough(logits), 1)

    lhs = kl = kl_divergence(dist(posteriors_logits.detach()), dist(priors_logits))
    rhs = kl_divergence(dist(posteriors_logits), dist(priors_logits.detach()))
    # clamp_min is jnp.maximum against the constant (no host tensor: a
    # captured step may not copy one across)
    if kl_free_avg:
        loss_lhs = lhs.mean().clamp_min(kl_free_nats)
        loss_rhs = rhs.mean().clamp_min(kl_free_nats)
    else:
        loss_lhs = lhs.clamp_min(kl_free_nats).mean()
        loss_rhs = rhs.clamp_min(kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return total, kl.mean(), kl_loss, reward_loss, observation_loss, continue_loss
