"""DroQ training (port of ``sheeprl_tpu/algos/droq/droq.py``: ``make_train_fn``
:47-218 and ``main`` :221-599) on one device, in SAC's off-policy loop
(``algos/sac/sac.py::train_offpolicy``).

SAC with dropout-Q critics and a replay ratio of 20. Each update runs G
critic-only gradient steps, each on its own batch, with the target EMA
after every step (JAX :96-119), then one actor and alpha update on a batch
of its own against the *mean* of the ensemble (:121-139). The critic steps
run as SAC's train window (chunks of ``algo.gradient_steps_chunk`` captured
as one CUDA graph, a remainder as replays of the one-step graph, or the
fused in-graph draws from the ring with ``algo.fused_gradient_steps``); the
actor update is one more graph. Dropout masks are drawn per critic and per
call from the train generator, which every graph registers (flax draws them
from a ``dropout`` rng per critic and step, :47); the target ensemble runs
with dropout too, as in the JAX step.

Checkpoints hold SAC's layout; NaN rollback, the crash guard and the
preemption exit are the loop's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import Batch, SACTrainer, _check_vector_obs, ema_, train_offpolicy, vector_algorithm
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer
from sheeprl_tpu_torch.device import DeviceLike
from sheeprl_tpu_torch.ops.graph import CapturedStep
from sheeprl_tpu_torch.utils.registry import register_algorithm


class DroQTrainer(SACTrainer):
    """DroQ's critic step (a :class:`SACTrainer` step without the actor)
    and its actor update (:meth:`actor_window`)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.dropout_gen = self.train_gen
        # the DroQ loop stores the next observation and never samples it
        self.sample_next_obs = False
        self._actor_metrics: Optional[torch.Tensor] = None

    def step(self, batch: Batch, count: int) -> torch.Tensor:
        """One critic step (JAX ``critic_step``, :96-119): SAC's critic
        update, then the target EMA."""
        qf_loss = self.critic_update(batch, self.agent.log_alpha.detach().exp())
        with torch.no_grad():
            ema_(list(self.agent.target_critic.parameters()), list(self.agent.critic.parameters()), self.tau)
        self.counter.add_(1)
        return qf_loss[None]

    def actor_update(self, batch: Batch) -> torch.Tensor:
        """The actor and alpha update against the ensemble's mean Q
        (JAX ``local_actor_update``, :121-139)."""
        alpha = self.agent.log_alpha.detach().exp()
        a_loss, alpha_loss = self.actor_and_alpha_update(batch["observations"], alpha, lambda q: q.mean(-1, keepdim=True))
        return torch.stack([a_loss, alpha_loss])

    def _actor_graph(self) -> CapturedStep:
        if "actor" not in self.graphs:
            inputs = {"observations": torch.zeros((self.batch_size, self.obs_dim), device=self.device)}
            self.graphs["actor"] = CapturedStep(self.actor_update, inputs, self.state_tensors(), (self.train_gen,))
        return self.graphs["actor"]

    def train_window(self, rb: Any, n_steps: int) -> List[Tuple[int, torch.Tensor]]:
        """G critic steps (SAC's window), then the actor update on a batch
        of its own, drawn after the critic batches (JAX :486-541)."""
        chunks = super().train_window(rb, n_steps)
        fn = self._actor_graph()
        if isinstance(rb, DeviceReplayBuffer):
            fn.inputs["observations"].copy_(rb.sample_transitions(self.batch_size)["observations"][0])
            self.h2d_bytes += self.batch_size * 8
        else:
            self._fill(fn.inputs, {"observations": rb.sample(self.batch_size)["observations"].astype(np.float32)}, 0)
            self.h2d_bytes += fn.inputs["observations"].numel() * 4
        self._actor_metrics = fn()
        self.dispatches += 1
        return chunks

    def window_metrics(self, chunks: List[Tuple[int, torch.Tensor]]) -> np.ndarray:
        """The critic steps' weighted mean loss, then the actor update's
        policy and alpha losses."""
        qf = super().window_metrics(chunks)
        return np.concatenate([qf, self._actor_metrics.float().cpu().numpy()])


def build_droq(cfg, obs_space, action_space, state, device, batch_size, fused_k):
    mlp_keys = _check_vector_obs(cfg, obs_space, "DroQ")
    agent, player = build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device=device)
    obs_dim = int(sum(np.prod(obs_space[k].shape) for k in mlp_keys))
    return DroQTrainer(agent, cfg, device, batch_size, fused_k, obs_dim, int(np.prod(action_space.shape))), player


DROQ = vector_algorithm("DroQ", build_droq, lambda cfg: True, vector_only=False)


@register_algorithm()
def main(fabric: Any, cfg: Optional[Dict[str, Any]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """Train DroQ, called as the CLI calls it, ``main(fabric, cfg)``, or as
    ``main(cfg, device=...)``; SAC's ``main`` contract and report."""
    return train_offpolicy(fabric, cfg, device, DROQ)
