"""The checkpoint callback (port of ``sheeprl_tpu/utils/callback.py``: the
pickle path of ``CheckpointCallback.on_checkpoint_coupled`` on one process,
with its ``ckpt/snapshot`` span and ``ckpt_committed``/``ckpt_skipped``
telemetry events).

Every save commits a manifest as its last write and then prunes to the
``keep_last`` newest committed checkpoints. With ``async_save`` the loop
blocks only for a host snapshot (every array copied, the replay buffer
deep-copied); serialization, commit and pruning run on the background
writer, at most one save in flight (a request that finds a write running is
dropped). ``emergency=True`` (preemption, crash) saves synchronously.

A replay buffer that rides the checkpoint is made self-consistent without
the env state: each env's last stored step is flagged truncated for the save
and restored right after (on the card, in place, for the device ring, JAX
``utils/callback.py:241-263``). A buffer pickles as host arrays: the ring
copies its storage off the card, a memmapped host buffer its files' contents.
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer
from sheeprl_tpu_torch.obs.span import span
from sheeprl_tpu_torch.obs.telemetry import telemetry_ckpt_commit, telemetry_ckpt_skipped
from sheeprl_tpu_torch.resilience.async_writer import get_async_writer
from sheeprl_tpu_torch.resilience.manifest import (
    build_manifest,
    checkpoint_step,
    committed_checkpoints,
    gc_torn,
    manifest_path,
)
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint


def _snapshot_tree(tree: Any) -> Any:
    """A copy of ``tree`` that shares no array with it."""
    if isinstance(tree, dict):
        return {k: _snapshot_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_snapshot_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class CheckpointCallback:
    def __init__(self, keep_last: Optional[int] = None, backend: str = "pickle", async_save: bool = False) -> None:
        self.keep_last = keep_last
        self.backend = backend
        self.async_save = bool(async_save)

    def on_checkpoint_coupled(
        self,
        ckpt_path: str,
        state: Dict[str, Any],
        replay_buffer: Any = None,
        emergency: bool = False,
    ) -> None:
        step = checkpoint_step(ckpt_path) or 0
        extra = {"emergency": True} if emergency else None
        if self.async_save and not emergency:
            writer = get_async_writer()
            if writer.busy:
                writer.record_skip()
                telemetry_ckpt_skipped(ckpt_path, step)
                return
            with span("ckpt/snapshot"):
                flags = self._ckpt_rb(replay_buffer)
                host_state = _snapshot_tree(state)
                if replay_buffer is not None:
                    host_state["rb"] = copy.deepcopy(replay_buffer)
                    self._experiment_consistent_rb(replay_buffer, flags)
            manifest = build_manifest(step=step, backend=self.backend, world_size=1, state=host_state, extra=extra)

            def write() -> None:
                save_checkpoint(ckpt_path, host_state, backend=self.backend, manifest=manifest)
                telemetry_ckpt_commit(ckpt_path, step, self.backend, emergency)
                self._prune(os.path.dirname(ckpt_path))

            writer.submit(write, path=ckpt_path)
            return
        flags = self._ckpt_rb(replay_buffer)
        if replay_buffer is not None:
            state = {**state, "rb": replay_buffer}
        manifest = build_manifest(step=step, backend=self.backend, world_size=1, state=state, extra=extra)
        try:
            save_checkpoint(ckpt_path, state, backend=self.backend, manifest=manifest)
        finally:
            self._experiment_consistent_rb(replay_buffer, flags)
        telemetry_ckpt_commit(ckpt_path, step, self.backend, emergency)
        self._prune(os.path.dirname(ckpt_path))

    @staticmethod
    def _ckpt_rb(rb: Any) -> Any:
        """Flag each env's last stored step truncated; returns the flags it
        overwrote."""
        if rb is None:
            return None
        if isinstance(rb, DeviceReplayBuffer):
            return rb.flag_last_truncated()
        if isinstance(rb, ReplayBuffer):
            last = (rb._pos - 1) % rb.buffer_size
            saved_row = np.array(rb.buffer["truncated"][last])
            rb.buffer["truncated"][last] = 1
            return saved_row
        if not isinstance(rb, EnvIndependentReplayBuffer):
            raise TypeError(f"checkpointing a {type(rb).__name__} is not ported")
        saved = []
        for b in rb.buffer:
            last = (b._pos - 1) % b.buffer_size
            saved.append(b.buffer["truncated"][last].copy())
            b.buffer["truncated"][last] = 1
        return saved

    @staticmethod
    def _experiment_consistent_rb(rb: Any, saved: Any) -> None:
        """Undo :meth:`_ckpt_rb`."""
        if rb is None:
            return
        if isinstance(rb, DeviceReplayBuffer):
            rb.restore_last_truncated(saved)
            return
        if isinstance(rb, ReplayBuffer):
            rb.buffer["truncated"][(rb._pos - 1) % rb.buffer_size] = saved
            return
        for b, s in zip(rb.buffer, saved):
            b.buffer["truncated"][(b._pos - 1) % b.buffer_size] = s

    def _prune(self, ckpt_dir: str) -> None:
        """Delete torn writes, then all but the ``keep_last`` newest
        committed checkpoints by manifest step (never by mtime); foreign
        files stay."""
        if not self.keep_last or not os.path.isdir(ckpt_dir):
            return
        gc_torn(ckpt_dir)
        committed = committed_checkpoints(ckpt_dir)
        for ckpt in committed[: max(len(committed) - self.keep_last, 0)]:
            try:
                shutil.rmtree(ckpt.path) if os.path.isdir(ckpt.path) else os.remove(ckpt.path)
                if os.path.isfile(manifest_path(ckpt.path)):
                    os.remove(manifest_path(ckpt.path))
            except OSError:
                pass
