"""Shared newest-committed-checkpoint discovery (port of
``sheeprl_tpu/resilience/discovery.py``, over ``resilience/manifest.py``).

"Find the newest checkpoint whose manifest committed, skipping anything
invalid", as ``cli_serve`` (serve the newest committed checkpoint in a dir)
and ``resume_from=auto`` (walk newest-first through per-candidate gates)
need it:

- :func:`newest_committed` — the newest committed checkpoint in one
  directory (manifest discipline included: only manifested checkpoints are
  candidates; torn writes stay where they are, for ``resume_from=auto``
  (``autoresume.scan_run_checkpoints``) to delete).
- :func:`newest_valid` — the gate-walk: candidates newest-first, each run
  through ordered ``gates`` (callables returning an error string or
  ``None``); the first survivor wins, every rejection is reported through
  ``on_reject`` so callers keep their own telemetry/warning styles.
- :func:`validation_load_gate` — the one gate every caller shares: the
  checkpoint must actually deserialize.

Sort order is (step, manifest wall_time) descending — the same total order
``resume_from=auto`` has always used, now everywhere.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from sheeprl_tpu_torch.resilience.manifest import CommittedCheckpoint, committed_checkpoints

# a gate inspects one candidate and returns None (pass) or the reason it
# must be skipped
Gate = Callable[[CommittedCheckpoint], Optional[str]]
RejectHook = Callable[[CommittedCheckpoint, str], None]


def sort_newest_first(candidates: Sequence[CommittedCheckpoint]) -> List[CommittedCheckpoint]:
    """(step, wall_time) descending — the canonical candidate order."""
    return sorted(
        candidates, key=lambda c: (c.step, c.manifest.get("wall_time", 0.0)), reverse=True
    )


def newest_valid(
    candidates: Sequence[CommittedCheckpoint],
    *,
    gates: Sequence[Gate] = (),
    on_reject: Optional[RejectHook] = None,
) -> Optional[CommittedCheckpoint]:
    """Walk ``candidates`` newest-first; return the first one passing every
    gate, reporting each rejection. ``None`` when nothing survives."""
    for cand in sort_newest_first(candidates):
        reason = None
        for gate in gates:
            reason = gate(cand)
            if reason is not None:
                break
        if reason is None:
            return cand
        if on_reject is not None:
            on_reject(cand, reason)
    return None


def newest_committed(
    ckpt_dir: str,
    *,
    gates: Sequence[Gate] = (),
    on_reject: Optional[RejectHook] = None,
) -> Optional[CommittedCheckpoint]:
    """The newest committed (manifested) checkpoint in ``ckpt_dir`` passing
    every gate."""
    return newest_valid(committed_checkpoints(ckpt_dir), gates=gates, on_reject=on_reject)


def validation_load_gate(cand: CommittedCheckpoint) -> Optional[str]:
    """The shared must-deserialize gate."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    try:
        load_checkpoint(cand.path)
    except Exception as exc:
        return f"validation load failed: {exc!r}"
    return None
