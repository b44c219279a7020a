"""A2C training (port of ``sheeprl_tpu/algos/a2c/a2c.py``: ``make_local_train``
:58-84, ``make_fused_local_train`` :87-98 and ``main`` :116-551), on one
device.

PPO's skeleton without clipping: one gradient step an update over the whole
rollout, the policy and value losses reduced by ``algo.loss_reduction``
(``sum``) and summed, RMSProp (``configs/algo/a2c.yaml`` selects
``optim/rmsprop``) behind global-norm clipping. The loop is PPO's
(``algos/ppo/ppo.py::train_onpolicy``): the host loop collects with
``collect_rollout`` and replays GAE and the update as one
``CapturedStep``; ``algo.fused_rollout=True`` runs the rollout, GAE and the
step as one ``ops/rollout_scan.py`` superstep behind PPO's gate, with its
``fused_fallback`` events. What A2C keeps of the JAX loop: the CNN keys are
dropped with a warning (the agent reads vectors only), and the host loop
does not bootstrap truncated episodes (the fused superstep does, as in the
JAX package). Checkpoints hold the JAX layout, the RMSProp state in optax's
nesting.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.a2c.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, evaluate_actions
from sheeprl_tpu_torch.algos.ppo.ppo import OnPolicyAlgorithm, train_onpolicy
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.ops.optim import Optimizer
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ("Loss/policy_loss", "Loss/value_loss")


def make_local_train(
    agent: PPOAgent,
    opt: Optimizer,
    cfg: Mapping[str, Any],
    obs_keys: Sequence[str],
    n_local: int,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """The update over a flat ``[n_local, ...]`` rollout (JAX :58-84):
    ``local_train(data, coefs=None) -> metrics [2]`` (the policy and value
    losses), one gradient of their sum and one optimizer step, in place.
    ``coefs`` (and ``generator``) are PPO's: A2C reads neither (the fused
    superstep's ``local_train`` contract passes them, JAX :87-98)."""
    reduction = str(cfg["algo"]["loss_reduction"])
    params = list(agent.parameters())

    def local_train(data: Dict[str, torch.Tensor], coefs: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.enable_grad():
            logprobs, _, values = evaluate_actions(agent, {k: data[k] for k in obs_keys}, data["actions"])
            pg = policy_loss(logprobs, data["advantages"], reduction)
            v = value_loss(values, data["returns"], reduction)
            grads = torch.autograd.grad(pg + v, params)
        opt.step(grads)
        return torch.stack([pg, v]).detach()

    return local_train


A2C = OnPolicyAlgorithm(
    make_local_train,
    lambda cfg, n_local: 1,
    METRIC_ORDER,
    frozenset(AGGREGATOR_KEYS),
    vector_only=True,
    bootstrap_truncated=False,
)


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train A2C, called as the CLI calls it, ``main(fabric, cfg)``, or as
    ``main(cfg, device=...)``; PPO's ``main`` contract and report."""
    return train_onpolicy(fabric, cfg, device, A2C)
