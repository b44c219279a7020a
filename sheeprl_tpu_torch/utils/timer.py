"""Wall-clock section timers (port of ``sheeprl_tpu/utils/timer.py``): ``timer``
is the telemetry span, :class:`sheeprl_tpu_torch.obs.span.span`, so the
class-level ``disabled`` flag and ``timers`` registry that the CLI and the
loop set and read are the span's."""

from sheeprl_tpu_torch.obs.span import TimerError, span as timer

__all__ = ["TimerError", "timer"]
