"""The run's resilience facade (port of
``sheeprl_tpu/resilience/manager.py::RunResilience`` on one process).

Telemetry calls (preemption, crash-checkpoint and rollback events) are left
out: telemetry is a later slice of the port. What the train loop calls:

- ``preempt_requested()`` at the top of each update; on ``True`` the loop
  saves through ``emergency_checkpoint`` and leaves, and the run ends with
  ``exit_preempted()`` (exit code :data:`PREEMPTED_EXIT_CODE`);
- ``check_finite(metrics, update)`` after each train window (the NaN fault
  drill first, then the host check), or ``window_ok`` with a verdict already
  reduced;
- ``rollback(update=...)`` when it trips: drains the async writer, loads the
  newest committed checkpoint of this run (or ``checkpoint.resume_from``),
  spends one of ``resilience.max_rollbacks`` and returns the state; an
  exhausted budget raises. The JAX ``place_like`` has no counterpart here:
  the loop copies the restored state into the live tensors in place
  (``dreamer_v3.load_checkpoint_state``), so a captured CUDA graph keeps
  reading them. ``resalt_key`` re-seeds the train generator away from the
  stream that diverged;
- ``arm_crash_guard(...)``: an unhandled exception in the loop is passed to
  ``crash_checkpoint``, which drains and writes an emergency checkpoint
  before the exception propagates.
"""

from __future__ import annotations

import hashlib
import os
import sys
import warnings
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from sheeprl_tpu_torch.resilience.async_writer import drain_async_checkpoints
from sheeprl_tpu_torch.resilience.manifest import committed_checkpoints
from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE, PreemptionWatcher
from sheeprl_tpu_torch.resilience.sentinel import host_all_finite, parse_nan_faults
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

# the salt of the post-rollback re-seed (the JAX package's fold_in salt)
ROLLBACK_KEY_SALT = 0x0BAD


class RunResilience:
    def __init__(self, cfg: Mapping[str, Any], log_dir: str, callback: Any = None) -> None:
        res_cfg: Mapping[str, Any] = cfg.get("resilience") or {}
        self.cfg = cfg
        self.callback = callback
        self.ckpt_dir = os.path.join(log_dir, "checkpoint")
        self.enabled = bool(res_cfg.get("enabled", True))
        self.finite_checks = self.enabled and bool(res_cfg.get("check_finite", True))
        self.max_rollbacks = int(res_cfg.get("max_rollbacks", 3) or 0)
        self.rollbacks = 0
        self._nan_faults = parse_nan_faults(res_cfg) if self.enabled else set()
        self._fired_faults: set = set()
        self.crash_checkpoints = self.enabled and bool(res_cfg.get("crash_checkpoint", True))
        self._crash_fns: Optional[tuple] = None
        self.watcher: Optional[PreemptionWatcher] = None
        if self.enabled and bool(res_cfg.get("preemption", True)):
            self.watcher = PreemptionWatcher().install()
        self._preempt_reported = False

    # -- preemption ----------------------------------------------------------

    def preempt_requested(self) -> bool:
        hit = self.watcher is not None and self.watcher.requested
        if hit and not self._preempt_reported:
            self._preempt_reported = True
            warnings.warn("preemption signal received — draining in-flight saves and writing an emergency checkpoint")
        return hit

    def emergency_checkpoint(self, ckpt_path: str, state: Dict[str, Any], replay_buffer: Any = None) -> None:
        """Drain the save in flight, then save synchronously (manifest
        marked ``emergency``)."""
        drain_async_checkpoints()
        self.callback.on_checkpoint_coupled(ckpt_path, state, replay_buffer, emergency=True)

    def exit_preempted(self) -> None:
        if self.watcher is not None:
            self.watcher.uninstall()
        sys.exit(PREEMPTED_EXIT_CODE)

    # -- crash guard ---------------------------------------------------------

    def arm_crash_guard(
        self,
        *,
        path_fn: Callable[[], str],
        state_fn: Callable[[], Dict[str, Any]],
        replay_buffer_fn: Optional[Callable[[], Any]] = None,
    ) -> None:
        """Keep the loop's checkpoint closures for :meth:`crash_checkpoint`;
        they read the loop's bindings at crash time."""
        if self.crash_checkpoints:
            self._crash_fns = (path_fn, state_fn, replay_buffer_fn)

    def crash_checkpoint(self, err: BaseException) -> Optional[str]:
        """Drain, then write an emergency checkpoint of the loop's current
        state; never raises (the original exception must propagate). Returns
        the path, or ``None`` when unarmed or the save failed."""
        fns, self._crash_fns = self._crash_fns, None
        if fns is None:
            return None
        path_fn, state_fn, buffer_fn = fns
        try:
            drain_async_checkpoints()
            path = str(path_fn())
            self.callback.on_checkpoint_coupled(
                path, state_fn(), buffer_fn() if buffer_fn is not None else None, emergency=True
            )
        except Exception as save_err:  # never mask the crash
            warnings.warn(f"crash guard: emergency checkpoint failed ({save_err!r})")
            return None
        warnings.warn(
            f"unhandled {type(err).__name__} in the train loop — wrote emergency checkpoint {path!r}; "
            "rerun with checkpoint.resume_from=auto to continue from this boundary"
        )
        return path

    # -- non-finite sentinel -------------------------------------------------

    def check_finite(self, metrics: Any, update: int) -> bool:
        """``False`` when this update's metrics hold NaN or Inf, or the
        fault drill says so."""
        if not self.finite_checks:
            return True
        return self.window_ok(host_all_finite(metrics), update)

    def window_ok(self, finite: bool, update: int) -> bool:
        if not self.finite_checks:
            return True
        if update in self._nan_faults and update not in self._fired_faults:
            self._fired_faults.add(update)
            warnings.warn(f"resilience.fault_injection: forcing non-finite metrics at update {update}")
            return False
        return bool(finite)

    def rollback(self, *, update: int) -> Dict[str, Any]:
        """The newest committed checkpoint's state; raises when the budget
        is spent or there is nothing to roll back to."""
        if self.rollbacks >= self.max_rollbacks:
            raise RuntimeError(
                f"non-finite training metrics at update {update} but the rollback budget "
                f"(resilience.max_rollbacks={self.max_rollbacks}) is exhausted — the run is "
                "diverging faster than checkpoints can save it; lower the learning rate or "
                "raise checkpoint frequency"
            )
        drain_async_checkpoints()
        candidates = committed_checkpoints(self.ckpt_dir)
        path: Optional[str] = candidates[-1].path if candidates else None
        if path is None:
            resume_from = (self.cfg.get("checkpoint") or {}).get("resume_from")
            if resume_from and resume_from != "auto" and os.path.exists(str(resume_from)):
                path = str(resume_from)
        if path is None:
            raise RuntimeError(
                f"non-finite training metrics at update {update} and no committed checkpoint "
                "to roll back to — lower checkpoint.every so a rollback point exists"
            )
        state = load_checkpoint(path)
        self.rollbacks += 1
        warnings.warn(
            f"non-finite training metrics at update {update}: rolled back to {path!r} "
            f"({self.max_rollbacks - self.rollbacks} rollback(s) left)"
        )
        return state

    # -- restore helpers -----------------------------------------------------

    def resalt_key(self, generator: torch.Generator) -> torch.Generator:
        """Re-seed ``generator`` from its own state and ``ROLLBACK_KEY_SALT
        + rollbacks``: replaying the same draws into the same weights
        usually reproduces the NaN."""
        salt = (ROLLBACK_KEY_SALT + self.rollbacks).to_bytes(8, "little")
        digest = hashlib.sha256(generator.get_state().numpy().tobytes() + salt).digest()
        return generator.manual_seed(int.from_bytes(digest[:8], "little") & (2**63 - 1))

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drain background saves and release the signal handlers."""
        self._crash_fns = None
        drain_async_checkpoints()
        if self.watcher is not None:
            self.watcher.uninstall()
