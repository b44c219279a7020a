"""Fused training supersteps: K gradient steps in one call (port of
``sheeprl_tpu/ops/superstep.py`` on one device, without ``shard_map``,
GSPMD or the executable cache).

The per-step loop issues, for each gradient step, a replay draw, maybe the
target refresh, and the step. A superstep moves the whole train window into
one callable that ``ops/graph.py::CapturedStep`` captures as one CUDA
graph: for each of its K steps, in the JAX scan body's order (:237-266),

1. the target-network refresh, gated on a device step counter (a hard copy
   at counter 0, ``tau`` every ``freq``-th step; :func:`periodic_target_ema`);
2. the replay batch (``gather``): a draw from the device ring
   (``data/device_buffer.py::draw_sequence_batch``) or batch ``i`` of a
   stack gathered on the host (:func:`pregathered`);
3. the train body;
4. a finite flag over the step's metrics and the parameters.

It returns the ``[K, n_metrics]`` metrics and the ``[K]`` finite vector on
the device: one fetch a window. The state the steps update lives in place
(parameters, optimizer state, Moments), where the JAX superstep carries it.
The in-graph draw takes its own generator, seeded apart from the train
generator with :data:`SAMPLE_KEY_SALT` as the JAX draw folds its key with
it, so index noise and gradient noise never share a stream.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.obs.telemetry import telemetry_fused_fallback
from sheeprl_tpu_torch.resilience.sentinel import all_finite

# the JAX package's salt for the replay draw's stream (:53)
SAMPLE_KEY_SALT = 0x5EED

_warned_fallback_reasons: set = set()


def fused_fallback(reason: str, detail: str) -> None:
    """Record that a fused path (``algo.fused_rollout``) could not run and
    the loop takes the host path: a ``fused_fallback`` telemetry event
    every time, and a ``UserWarning`` once a reason a run (JAX :81-96)."""
    telemetry_fused_fallback(reason, detail)
    if reason not in _warned_fallback_reasons:
        _warned_fallback_reasons.add(reason)
        warnings.warn(detail, UserWarning, stacklevel=3)


def reset_fused_fallback_warnings() -> None:
    """Warn again for every reason (a new run)."""
    _warned_fallback_reasons.clear()


def pregathered(ctx: Dict[str, torch.Tensor], step_index: int) -> Dict[str, torch.Tensor]:
    """Batch ``step_index`` of a ``[K, T, B, ...]`` stack drawn on the host
    by the buffer's own generator, as the per-step path draws."""
    return {k: v[step_index] for k, v in ctx.items()}


@torch.no_grad()
def periodic_target_ema(
    counter: torch.Tensor, source: Sequence[torch.Tensor], target: Sequence[torch.Tensor], freq: int, tau: float
) -> None:
    """``target = keep * target + take * source`` in place, with the blend
    picked on the device from ``counter``, the run's gradient steps before
    this one: ``(0, 1)`` at counter 0 (the hard copy), ``(1 - tau, tau)``
    when ``counter % freq == 0``, else ``(1, 0)``. The products and the sum
    are the host loop's (``dreamer_v3.ema_``), so a refresh here equals it
    bit for bit, and ``(1, 0)`` leaves a finite target as it was."""
    refresh = ((counter % freq) == 0).to(torch.float32)
    first = (counter == 0).to(torch.float32)
    take = refresh * (first + (1 - first) * tau)
    keep = refresh * (1 - first) * (1 - tau) + (1 - refresh)
    target = list(target)
    torch._foreach_mul_(target, keep)
    torch._foreach_add_(target, torch._foreach_mul(list(source), take))


def make_superstep_fn(
    train_body: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    gather: Callable[[Any, int], Dict[str, torch.Tensor]],
    num_steps: int,
    *,
    pre_step: Optional[Callable[[torch.Tensor], None]] = None,
    params: Sequence[torch.Tensor] = (),
) -> Callable[[torch.Tensor, Any], Tuple[torch.Tensor, torch.Tensor]]:
    """``superstep(counter, ctx) -> (metrics [K, n], finite [K])`` over
    ``num_steps`` steps: ``pre_step(counter + i)`` (the target refresh),
    ``batch = gather(ctx, i)``, ``metrics = train_body(batch)``, and
    ``finite[i]``, every value of the step's metrics and of ``params`` (the
    parameters after its update) finite. ``counter`` is a 0-d integer
    tensor: the run's gradient steps before the window."""
    if num_steps <= 0:
        raise ValueError(f"'num_steps' ({num_steps}) must be greater than 0")

    def superstep(counter: torch.Tensor, ctx: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        rows, finite = [], []
        for i in range(num_steps):
            if pre_step is not None:
                pre_step(counter + i)
            metrics = train_body(gather(ctx, i))
            rows.append(metrics)
            # metrics catch a NaN loss; the parameters an Inf that reached
            # the weights while the losses still looked sane
            finite.append(all_finite([metrics, *params]))
        return torch.stack(rows), torch.stack(finite)

    return superstep
