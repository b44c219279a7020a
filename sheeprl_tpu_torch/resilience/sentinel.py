"""Non-finite sentinel (port of ``sheeprl_tpu/resilience/sentinel.py``).

- :func:`all_finite`: one device boolean, ``True`` when every floating
  tensor of a tree is finite (no host sync);
- :func:`host_all_finite`: the same over values already on the host;
- :func:`parse_nan_faults`: the drill schedule of
  ``resilience.fault_injection`` (``{kind: nan, at_update: k}`` entries),
  at which the sentinel reports non-finite once, whatever the metrics.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Mapping, Set

import numpy as np
import torch


def _leaves(node: Any) -> Iterator[Any]:
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def all_finite(tree: Any) -> torch.Tensor:
    """A 0-d bool tensor: every floating tensor leaf of ``tree`` is finite.
    Integer and bool leaves are ignored; a tree with no floating leaf is
    finite."""
    tensors = [t.detach() for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not tensors:
        return torch.tensor(True)
    # 0 * x is 0 where x is finite and NaN where it is not, and a norm of
    # zeros is 0 where a NaN makes it NaN: a few multi-tensor launches for
    # any number of tensors, and no overflow from large finite values
    norms = torch._foreach_norm(torch._foreach_mul(tensors, 0.0))
    return torch.isfinite(torch.stack([n.float() for n in norms])).all()


def host_all_finite(tree: Any) -> bool:
    """:func:`all_finite` over host values (numpy arrays, Python floats,
    CPU tensors); non-numeric leaves are ignored."""
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        try:
            arr = np.asarray(leaf)
        except Exception:
            continue
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            return False
    return True


def parse_nan_faults(res_cfg: Mapping[str, Any]) -> Set[int]:
    """Updates at which the sentinel must report non-finite, from
    ``resilience.fault_injection`` (``enabled`` and a ``faults`` list of
    ``{kind: nan, at_update: k}``)."""
    fi = res_cfg.get("fault_injection") or {}
    if not bool(fi.get("enabled", False)):
        return set()
    updates: Set[int] = set()
    faults: List[Any] = fi.get("faults") or []
    for spec in faults:
        if not isinstance(spec, Mapping):
            raise ValueError(f"resilience.fault_injection.faults entries must be mappings, got {spec!r}")
        kind = str(spec.get("kind", "nan"))
        if kind != "nan":
            raise ValueError(f"unknown resilience fault kind {kind!r} (only 'nan' is defined)")
        at = spec.get("at_update")
        if at is None:
            raise ValueError(f"resilience fault {spec!r} needs at_update")
        updates.add(int(at))
    return updates
