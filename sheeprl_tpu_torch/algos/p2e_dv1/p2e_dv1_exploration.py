"""Plan2Explore on Dreamer-V1, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``: ``make_train_fn``
:75-339 and ``main`` :342-772).

One gradient step runs the JAX step's updates in its order:

1. the world model, as Dreamer-V1's (Gaussian RSSM, free-nats KL), with
   the reward and continue heads reading detached latents;
2. the ensemble in **embedding space**: each member predicts the next
   step's encoder output from ``(z, h, action)`` (JAX :191), the sum over
   members of each member's mean ``Normal(pred, 1)`` negative
   log-likelihood;
3. the exploration actor on the updated world model and ensemble, by
   dynamics backpropagation: the intrinsic reward is the members'
   population variance (``jnp.var`` is ddof 0) averaged over the
   embedding, times ``intrinsic_reward_multiplier`` (JAX :233), and its
   ``H - 1`` lambda targets come from ``compute_lambda_values_dv1``
   against the exploration critic itself (no target critic, :235);
4. the exploration critic against those targets;
5. the task actor and critic over a second imagination, Dreamer-V1's
   objective on the world model's reward (zero-shot).

``main`` is P2E-DV2's ``exploration_main`` with this step and no target
critic to refresh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _grads
from sheeprl_tpu_torch.algos.p2e_dv1.agent import P2EDV1Agent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import METRIC_ORDER, ensemble_loss, exploration_main
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import intrinsic_reward
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.ops.optim import Adam
from sheeprl_tpu_torch.utils.registry import register_algorithm

__all__ = ["METRIC_ORDER", "main", "make_train_step"]


def make_train_step(agent: P2EDV1Agent, opts: Mapping[str, Adam], cfg: Dict[str, Any], is_continuous: bool):
    """One exploration gradient step over a time-major ``[T, B]`` batch.

    Returns ``train_step(data, generator=None, grads_out=None) ->
    metrics [22]`` (``METRIC_ORDER``): it updates every trained model and
    optimizer in place. ``grads_out``, a dict, receives each model's
    gradients before clipping, keyed by the models' checkpoint keys. The
    actors learn by dynamics backpropagation whatever the action space, as
    Dreamer-V1's does."""
    algo = cfg["algo"]
    horizon, gamma, lmbda = int(algo["horizon"]), float(algo["gamma"]), float(algo["lmbda"])
    use_continues = bool(algo["world_model"]["use_continues"])
    multiplier = float(algo["intrinsic_reward_multiplier"])
    wm, ensemble = agent.world_model, agent.ensembles

    def behaviour(actor, critic, start, reward_fn, generator):
        """Dreamer-V1's behaviour objective (JAX :218-300): ``(policy_loss,
        trajectories, lambda_values, discount, values, reward)``."""
        trajectories, actions = dv1.imagine(wm, actor, *start, horizon, generator)
        values = critic(trajectories)
        reward = reward_fn(trajectories, actions)
        continues = dv1.continues_of(wm, trajectories, reward, use_continues, gamma)
        lambda_values, discount = dv1.behaviour_targets(reward, values, continues, lmbda)
        return -torch.mean(discount * lambda_values), trajectories, lambda_values, discount, values, reward

    def train_step(
        data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, grads_out: Optional[Dict[str, List[torch.Tensor]]] = None
    ) -> torch.Tensor:
        T, B = data["rewards"].shape[:2]
        # 1. the world model
        embedded, hs, zs, wm_metrics, wm_gnorm, wm_grads = dv1.world_model_step(wm, opts["world_optimizer"], data, cfg, generator, detach_heads=True)
        # 2. the ensemble, in embedding space
        ens_loss = ensemble_loss(ensemble, torch.cat([zs.detach(), hs.detach(), data["actions"]], -1), embedded.detach()[1:])
        ens_grads = _grads(ens_loss, list(ensemble.parameters()))
        ens_gnorm = opts["ensemble_optimizer"].step(ens_grads)
        start = (zs.detach().reshape(T * B, -1), hs.detach().reshape(T * B, -1))

        # 3. the exploration actor on the disagreement, 4. its critic
        expl_loss, expl_traj, expl_lambda, expl_discount, expl_values, intrinsic = behaviour(
            agent.actor_exploration,
            agent.critic_exploration,
            start,
            lambda trajectories, actions: intrinsic_reward(ensemble, trajectories, actions, multiplier),
            generator,
        )
        expl_grads = _grads(expl_loss, list(agent.actor_exploration.parameters()))
        expl_gnorm = opts["actor_exploration_optimizer"].step(expl_grads)
        value_loss_expl = dv1.value_loss(agent.critic_exploration, expl_traj, expl_lambda, expl_discount)
        critic_expl_grads = _grads(value_loss_expl, list(agent.critic_exploration.parameters()))
        critic_expl_gnorm = opts["critic_exploration_optimizer"].step(critic_expl_grads)

        # 5. the task actor and critic (zero-shot)
        task_loss, task_traj, task_lambda, task_discount, _, _ = behaviour(
            agent.actor_task, agent.critic_task, start, lambda trajectories, actions: wm.reward_mean(trajectories), generator
        )
        task_grads = _grads(task_loss, list(agent.actor_task.parameters()))
        task_gnorm = opts["actor_task_optimizer"].step(task_grads)
        value_loss_task = dv1.value_loss(agent.critic_task, task_traj, task_lambda, task_discount)
        critic_task_grads = _grads(value_loss_task, list(agent.critic_task.parameters()))
        critic_task_gnorm = opts["critic_task_optimizer"].step(critic_task_grads)

        if grads_out is not None:
            grads_out.update(
                world_model=wm_grads,
                ensembles=ens_grads,
                actor_exploration=expl_grads,
                critic_exploration=critic_expl_grads,
                actor_task=task_grads,
                critic_task=critic_task_grads,
            )
        return torch.stack(
            [
                *wm_metrics,
                ens_loss,
                expl_loss,
                value_loss_expl,
                task_loss,
                value_loss_task,
                intrinsic.mean(),
                expl_values.detach().mean(),
                expl_lambda.detach().mean(),
                wm_gnorm,
                ens_gnorm,
                expl_gnorm,
                critic_expl_gnorm,
                task_gnorm,
                critic_task_gnorm,
            ]
        ).detach()

    return train_step


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Explore with Plan2Explore on Dreamer-V1, called as the CLI calls it,
    ``main(fabric, cfg)``, or as ``main(cfg, device=...)`` (the CUDA card
    unless ``device="cpu"``), for ``algo.total_steps`` env steps: uniform
    random actions up to ``algo.learning_starts`` on a fresh run, then the
    exploration actor; ``Ratio``'s gradient steps."""
    return exploration_main(fabric, cfg, device, build_agent, make_train_step, None)
