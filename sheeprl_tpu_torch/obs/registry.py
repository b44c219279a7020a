"""Run registry: one durable line per run in ``RUNS.jsonl`` (port of
``sheeprl_tpu/obs/registry.py``, the same records, path rules and schema).

The train entry point (``cli.run_algorithm``), ``cli_eval`` and ``cli_serve``
(``kind="serve"``, with the last ``serve_stats`` snapshot) append ONE
compact JSON record at run end: what ran (algo, env, config digest, git
sha), how it went (the telemetry rollup, ``RunTelemetry.run_summary``: SPS,
MFU, duty cycle, device memory peak, CUDA-graph captures, checkpoint and
rollback counts, final losses) and how it ended (``completed | preempted |
crashed | rolled_back``).

Appends are atomic (``O_APPEND`` + ``flock``), so concurrent runs on one
host interleave whole lines; the reader skips unparsable lines.

Path resolution, first match wins:

1. explicit ``path=`` argument,
2. ``cfg.metric.telemetry.runs_jsonl`` (set to ``false`` to disable),
3. ``SHEEPRL_TPU_RUNS_JSONL`` env var (empty string disables),
4. ``<cwd>/RUNS.jsonl``.

Records carry ``schema`` (currently :data:`SCHEMA_VERSION`); readers keep
older-schema records and skip newer-schema ones they cannot interpret.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Mapping, Optional

SCHEMA_VERSION = 1
_ENV_VAR = "SHEEPRL_TPU_RUNS_JSONL"

OUTCOMES = ("completed", "preempted", "crashed", "rolled_back", "actor_exhausted", "learner_crashed")


# ------------------------------------------------------------------ paths ----


def runs_jsonl_path(cfg: Optional[Mapping[str, Any]] = None, path: Optional[str] = None) -> Optional[str]:
    """Resolve the registry path (see module docstring); ``None`` = disabled."""
    if path is not None:
        return path or None
    tel_cfg = (((cfg or {}).get("metric") or {}).get("telemetry")) or {}
    cfg_path = tel_cfg.get("runs_jsonl")
    if cfg_path is False:
        return None
    if cfg_path:
        return str(cfg_path)
    if _ENV_VAR in os.environ:
        return os.environ[_ENV_VAR] or None
    return os.path.join(os.getcwd(), "RUNS.jsonl")


# ------------------------------------------------------------ record build ----


def config_digest(cfg: Mapping[str, Any]) -> str:
    """Short stable digest of the composed run config (sorted-key JSON)."""
    try:
        as_dict = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        blob = json.dumps(as_dict, sort_keys=True, default=str)
    except Exception:
        blob = repr(cfg)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def build_run_record(
    cfg: Optional[Mapping[str, Any]],
    *,
    kind: str,
    outcome: str,
    summary: Optional[Mapping[str, Any]] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """Assemble one registry record. ``summary`` is
    :meth:`~sheeprl_tpu_torch.obs.telemetry.RunTelemetry.run_summary` when telemetry
    ran (rollup + topology + final metrics); without it the record still pins
    identity (kind/algo/env/digest/sha/outcome), so the registry works even
    for ``metric.telemetry.enabled=False`` runs."""
    record: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "t": time.time(),
        "kind": str(kind),
        "outcome": outcome if outcome in OUTCOMES else "crashed",
        "git_sha": git_sha(),
    }
    if cfg:
        algo = (cfg.get("algo") or {}) if isinstance(cfg.get("algo"), Mapping) else {}
        env = (cfg.get("env") or {}) if isinstance(cfg.get("env"), Mapping) else {}
        record["algo"] = algo.get("name")
        record["env"] = env.get("id")
        record["exp_name"] = cfg.get("exp_name")
        record["run_name"] = cfg.get("run_name")
        record["seed"] = cfg.get("seed")
        record["config_digest"] = config_digest(cfg)
    if summary:
        record.update(dict(summary))
    record.update(extra)
    return record


# ---------------------------------------------------------------- append ----


def append_run_record(record: Mapping[str, Any], path: str) -> None:
    """Atomically append ``record`` as one JSONL line.

    ``O_APPEND`` makes single-``write`` appends atomic on POSIX; the
    advisory ``flock`` additionally serializes writers that might split a
    very large record across writes."""
    line = json.dumps(dict(record), default=str) + "\n"
    data = line.encode()
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX)
        except Exception:
            pass  # flock unavailable (exotic fs): O_APPEND still holds
        os.write(fd, data)
    finally:
        os.close(fd)


def read_run_records(path: str) -> List[Dict[str, Any]]:
    """All parseable records in ``path``, file order. Unparsable lines and
    records from a NEWER schema than this reader understands are skipped."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if int(rec.get("schema", 1) or 1) > SCHEMA_VERSION:
                    continue
                records.append(rec)
    except OSError:
        return []
    return records


# ------------------------------------------------------------- run-end hook ----


def register_run(
    cfg: Optional[Mapping[str, Any]],
    *,
    kind: str,
    outcome: str,
    error: Optional[str] = None,
    path: Optional[str] = None,
    **extra: Any,
) -> Optional[Dict[str, Any]]:
    """The entrypoint hook: roll up the active telemetry (if any), build the
    record and append it. Never raises — a registry failure must not mask
    the run's own outcome. Returns the record (or ``None`` when the registry
    is disabled or the append failed)."""
    try:
        resolved = runs_jsonl_path(cfg, path)
        if not resolved:
            return None
        from sheeprl_tpu_torch.obs.telemetry import get_telemetry

        tel = get_telemetry()
        summary = tel.run_summary() if tel is not None else None
        # a crash after one or more NaN rollbacks is the rollback budget (or
        # its aftermath) ending the run — classify it as such
        if outcome == "crashed" and summary and summary.get("nan_rollbacks"):
            outcome = "rolled_back"
        if error:
            extra = {**extra, "error": str(error)[:500]}
        record = build_run_record(cfg, kind=kind, outcome=outcome, summary=summary, **extra)
        append_run_record(record, resolved)
        return record
    except Exception:
        return None
