"""The per-log-interval throughput block of the training loops (port of
``sheeprl_tpu/obs/heartbeat.py``): ``Time/sps_*`` from the span window, the
span registry reset, and, when run telemetry is active, the same window fed
to :meth:`RunTelemetry.heartbeat`, so the JSONL stream and the TensorBoard
scalars report the same numbers.

Callers pass their own window deltas (the env-steps formula differs between
on-policy and off-policy loops) and reset their ``last_log``/``last_train``
bookkeeping themselves.
"""

from __future__ import annotations

import math
from typing import Optional

from sheeprl_tpu_torch.obs.span import span
from sheeprl_tpu_torch.obs.telemetry import get_telemetry


def log_sps_and_heartbeat(
    logger,
    *,
    policy_step: int,
    env_steps: float,
    train_steps: float,
    train_invocations: Optional[float] = None,
) -> None:
    """Log ``Time/sps_train`` / ``Time/sps_env_interaction`` for the window
    since the last call, reset the span registry, and emit a telemetry
    heartbeat when the subsystem is active.

    ``env_steps``/``train_steps`` are the caller's window deltas;
    ``train_invocations`` is how many gradient steps ran in the window
    (feeds MFU; None when the loop has no registered FLOP source)."""
    timer_window = {}
    if not span.disabled:
        # a timer registered earlier in the process that did not run in this
        # window computes NaN: it is left out, not reported as a NaN rate
        timer_window = {k: v for k, v in span.compute().items() if not math.isnan(v)}
        sps = {}
        if timer_window.get("Time/train_time"):
            sps["Time/sps_train"] = train_steps / timer_window["Time/train_time"]
        if timer_window.get("Time/env_interaction_time"):
            sps["Time/sps_env_interaction"] = env_steps / timer_window["Time/env_interaction_time"]
        if sps:
            logger.log_metrics(sps, policy_step)
        span.reset()
    tel = get_telemetry()
    if tel is not None:
        tel.heartbeat(
            logger,
            step=policy_step,
            env_steps=env_steps,
            train_steps=train_steps,
            train_invocations=train_invocations,
            timer_window=timer_window,
        )
