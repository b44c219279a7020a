"""Dreamer-V3 world-model loss (port of
``sheeprl_tpu/algos/dreamer_v3/loss.py:19-70``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.ops.distributions import Independent, OneHotCategoricalStraightThrough, kl_divergence


def _categorical(logits: torch.Tensor) -> Independent:
    return Independent(OneHotCategoricalStraightThrough(logits), 1)


def reconstruction_loss(
    po: Dict[str, object],
    observations: Dict[str, torch.Tensor],
    pr: object,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[object] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """Eq. 5 of the Dreamer-V3 paper: observation, reward and continue NLL
    plus the KL-balanced dynamics and representation terms with free nats.
    ``priors_logits``/``posteriors_logits`` are ``[T, B, S, D]``. Returns
    ``(loss, kl, state_loss, reward_loss, observation_loss,
    continue_loss)``."""
    observation_loss = -sum(po[k].log_prob(observations[k].float()) for k in po)
    reward_loss = -pr.log_prob(rewards)
    kl = kl_divergence(_categorical(posteriors_logits.detach()), _categorical(priors_logits))
    dyn_loss = kl_dynamic * torch.clamp_min(kl, kl_free_nats)
    repr_loss = kl_divergence(_categorical(posteriors_logits), _categorical(priors_logits.detach()))
    repr_loss = kl_representation * torch.clamp_min(repr_loss, kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return total, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
