"""Host-side metric aggregation (port of ``sheeprl_tpu/utils/metric.py``).

The composed ``metric.aggregator`` node instantiates ``MetricAggregator``
with its ``metrics`` (``MeanMetric`` nodes, whose ``sync_on_compute`` has
nothing to reduce on one process). The train loop keeps each gradient
step's metric vector on the device, stacks the pending ones at log time and
fetches them in one copy; the aggregator then reduces plain floats on the
host. ``MetricAggregator.disabled`` is the class-level switch that the CLI
sets from ``metric.log_level``.
"""

from __future__ import annotations

import warnings
from math import isnan
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Union

import numpy as np


class MetricAggregatorException(Exception):
    pass


class Metric:
    """Minimal accumulator interface: update / compute / reset."""

    def update(self, value: Any) -> None:
        raise NotImplementedError

    def compute(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class MeanMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **_: Any) -> None:
        self._sum = 0.0
        self._count = 0

    def update(self, value: Any) -> None:
        self._sum += float(value)
        self._count += 1

    def compute(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def reset(self) -> None:
        self._sum, self._count = 0.0, 0


class SumMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **_: Any) -> None:
        self._sum = 0.0
        self._any = False

    def update(self, value: Any) -> None:
        self._sum += float(value)
        self._any = True

    def compute(self) -> float:
        return self._sum if self._any else float("nan")

    def reset(self) -> None:
        self._sum, self._any = 0.0, False


class LastValueMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **_: Any) -> None:
        self._value = float("nan")

    def update(self, value: Any) -> None:
        self._value = float(value)

    def compute(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = float("nan")


class MaxMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **_: Any) -> None:
        self._value = float("nan")

    def update(self, value: Any) -> None:
        v = float(value)
        self._value = v if isnan(self._value) else max(self._value, v)

    def compute(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = float("nan")


_METRIC_TYPES = {"mean": MeanMetric, "sum": SumMetric, "last": LastValueMetric, "max": MaxMetric}


def make_metric(spec: Any) -> Metric:
    """A metric from an instance, a class, a name (``"mean"``) or a
    ``_target_`` node."""
    if isinstance(spec, Metric):
        return spec
    if isinstance(spec, type) and issubclass(spec, Metric):
        return spec()
    if isinstance(spec, Mapping) and "_target_" in spec:
        spec = spec["_target_"]
    if isinstance(spec, str):
        key = spec.rsplit(".", 1)[-1].replace("Metric", "").lower()
        if key in _METRIC_TYPES:
            return _METRIC_TYPES[key]()
    raise ValueError(f"unknown metric spec {spec!r}; available: {sorted(_METRIC_TYPES)}")


class MetricAggregator:
    """Named metrics with a class-level ``disabled`` switch; ``compute``
    drops the empty (NaN) ones. ``metrics`` maps names to metric specs, or
    is an iterable of names (means)."""

    disabled: bool = False

    def __init__(self, metrics: Union[Mapping[str, Any], Iterable[str], None] = None, raise_on_missing: bool = False) -> None:
        if metrics is not None and not isinstance(metrics, Mapping):
            metrics = {name: "mean" for name in metrics}
        self.metrics: Dict[str, Metric] = {k: make_metric(v) for k, v in (metrics or {}).items()}
        self._raise_on_missing = raise_on_missing

    def __iter__(self) -> Iterator[str]:
        return iter(self.metrics.keys())

    def _missing(self, name: str, action: str) -> None:
        if self._raise_on_missing:
            raise MetricAggregatorException(f"Metric {name} does not exist")
        warnings.warn(f"The key '{name}' is missing from the metric aggregator. Nothing will be {action}.")

    def add(self, name: str, metric: Any) -> None:
        if self.disabled:
            return
        if name in self.metrics:
            if self._raise_on_missing:
                raise MetricAggregatorException(f"Metric {name} already exists")
            warnings.warn(f"The key '{name}' is already in the metric aggregator. Nothing will be added.")
            return
        self.metrics[name] = make_metric(metric)

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            self._missing(name, "added")
            return
        for v in np.asarray(value, dtype=np.float64).ravel():
            self.metrics[name].update(v)

    def pop(self, name: str) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            self._missing(name, "popped")
        self.metrics.pop(name, None)

    def reset(self) -> None:
        if self.disabled:
            return
        for m in self.metrics.values():
            m.reset()

    def compute(self) -> Dict[str, float]:
        if self.disabled:
            return {}
        out = {k: m.compute() for k, m in self.metrics.items()}
        return {k: v for k, v in out.items() if not isnan(v)}


def build_aggregator(cfg: Mapping[str, Any], keys: Iterable[str]) -> MetricAggregator:
    """The run's aggregator: the composed ``metric.aggregator`` node
    instantiated (``MetricAggregator`` with its metrics), then a mean for
    each of ``keys`` it lacks (JAX ``dreamer_v3.py:543-545``)."""
    from sheeprl_tpu_torch.config.compose import instantiate

    node: Optional[Mapping[str, Any]] = (cfg.get("metric") or {}).get("aggregator")
    aggregator = instantiate(node) if node and "_target_" in node else MetricAggregator()
    for k in sorted(set(keys) - set(aggregator.metrics)):
        aggregator.add(k, "mean")
    return aggregator
