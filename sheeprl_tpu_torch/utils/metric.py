"""Host-side metric aggregation (port of ``sheeprl_tpu/utils/metric.py``:
``MeanMetric`` and ``MetricAggregator``, the two the Dreamer-V3 exp uses).

The train loop keeps each gradient step's metric vector on the device,
stacks the pending ones once at log time and fetches them in one copy; the
aggregator then reduces plain floats on the host.
"""

from __future__ import annotations

from math import isnan
from typing import Any, Dict, Iterable, Optional

import numpy as np


class MeanMetric:
    def __init__(self) -> None:
        self._sum = 0.0
        self._count = 0

    def update(self, value: Any) -> None:
        self._sum += float(value)
        self._count += 1

    def compute(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def reset(self) -> None:
        self._sum, self._count = 0.0, 0


class MetricAggregator:
    """Named means; ``compute`` drops the empty (NaN) ones."""

    def __init__(self, names: Optional[Iterable[str]] = None) -> None:
        self.metrics: Dict[str, MeanMetric] = {n: MeanMetric() for n in names or ()}

    def update(self, name: str, value: Any) -> None:
        metric = self.metrics.setdefault(name, MeanMetric())
        for v in np.asarray(value, dtype=np.float64).ravel():
            metric.update(v)

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()

    def compute(self) -> Dict[str, float]:
        out = {k: m.compute() for k, m in self.metrics.items()}
        return {k: v for k, v in out.items() if not isnan(v)}
