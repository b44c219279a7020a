"""``checkpoint.resume_from=auto`` (port of
``sheeprl_tpu/resilience/autoresume.py`` with ``discovery.newest_valid``,
with its ``resume_fallback`` telemetry events).

``auto`` scans the run's base directory (``<log_base_dir>/<root_dir>/
<run_name>``, every ``version_N`` under it), deletes torn writes, and walks
the committed checkpoints newest step first through two gates: the version
directory still holds the ``config.yaml`` of its run, and the checkpoint
loads. A candidate that fails one is skipped with a warning; with none left
the run starts afresh (``None``). The JAX package's third gate, whether the
stored global batch splits over the resuming mesh, has nothing to check on
one process and one card: ``main`` takes the whole batch.

Resolution runs in ``cli.run`` before telemetry exists, so the
``resume_fallback`` and ``auto_resume`` events are queued here and flushed
by ``cli.run_algorithm`` right after ``configure_telemetry``
(:func:`emit_pending_resilience_events`), as the JAX package does.
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

from sheeprl_tpu_torch.obs.telemetry import get_telemetry
from sheeprl_tpu_torch.resilience.manifest import CommittedCheckpoint, committed_checkpoints, gc_torn
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import run_base_dir


_pending_events: List[Tuple[str, Dict[str, Any]]] = []


def queue_resilience_event(kind: str, **fields: Any) -> None:
    """Stash an event for emission once telemetry is configured."""
    _pending_events.append((kind, fields))


def emit_pending_resilience_events() -> None:
    """Flush the events queued before ``configure_telemetry`` ran; drops
    them when telemetry is off."""
    tel = get_telemetry()
    events, _pending_events[:] = list(_pending_events), []
    if tel is None:
        return
    for kind, fields in events:
        if kind == "resume_fallback":
            tel.record_resume_fallback(fields.pop("path", ""), fields.pop("error", ""), **fields)
        else:
            tel.emit(kind, **fields)
    tel.writer.flush()


def scan_run_checkpoints(run_root: str) -> List[CommittedCheckpoint]:
    """Every committed checkpoint under ``run_root``'s
    ``version_*/checkpoint`` directories, newest first (step, then wall
    time); torn writes are deleted on the way."""
    found: List[CommittedCheckpoint] = []
    for version_dir in sorted(glob.glob(os.path.join(run_root, "version_*"))):
        ckpt_dir = os.path.join(version_dir, "checkpoint")
        for removed in gc_torn(ckpt_dir):
            warnings.warn(f"auto-resume: garbage-collected torn checkpoint write {removed!r}")
        found.extend(committed_checkpoints(ckpt_dir))
    found.sort(key=lambda c: (c.step, c.manifest.get("wall_time", 0.0)), reverse=True)
    return found


def _config_gate(cand: CommittedCheckpoint) -> Optional[str]:
    config_path = os.path.join(os.path.dirname(os.path.dirname(cand.path)), "config.yaml")
    return None if os.path.isfile(config_path) else f"missing {config_path}"


def _load_gate(cand: CommittedCheckpoint) -> Optional[str]:
    try:
        load_checkpoint(cand.path)
    except Exception as exc:
        return f"validation load failed: {exc!r}"
    return None


def resolve_auto_resume(cfg: Mapping[str, Any]) -> Optional[str]:
    """The newest valid committed checkpoint of the run of ``cfg``, or
    ``None`` for a fresh start."""
    run_root = run_base_dir(cfg)
    candidates = scan_run_checkpoints(run_root)
    if not candidates:
        warnings.warn(
            f"checkpoint.resume_from=auto found no committed checkpoint under {run_root!r} — starting a fresh run"
        )
        return None
    for cand in candidates:
        reason = _config_gate(cand) or _load_gate(cand)
        if reason is None:
            queue_resilience_event("auto_resume", path=cand.path, ckpt_step=cand.step, candidates=len(candidates))
            return cand.path
        queue_resilience_event("resume_fallback", path=cand.path, error=reason, ckpt_step=cand.step)
        warnings.warn(
            f"auto-resume: skipping checkpoint {cand.path!r} (step {cand.step}): {reason} — "
            "falling back to the next-newest"
        )
    warnings.warn(
        f"checkpoint.resume_from=auto: all {len(candidates)} committed checkpoints under "
        f"{run_root!r} were rejected — starting a fresh run"
    )
    return None
