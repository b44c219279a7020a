"""Checkpoint commit manifests (port of
``sheeprl_tpu/resilience/manifest.py``, pickle layout).

A checkpoint exists only once its manifest does: the payload is written
first, then ``<ckpt>.manifest.json`` lands last as the commit marker.
Pruning, ``resume_from=auto`` and the NaN rollback enumerate checkpoints
through :func:`committed_checkpoints` only; entries that follow the naming
scheme without a valid manifest are torn writes, which :func:`gc_torn`
deletes. Foreign files are neither counted nor deleted.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_VERSION = 1

# ckpt_<policy_step>_<rank>.ckpt
CKPT_NAME_RE = re.compile(r"^ckpt_(\d+)_(\d+)\.ckpt$")
# the staging prefix of the JAX package's orbax promotes, torn if left over
TMP_PREFIX = ".tmp-"


class CommittedCheckpoint(NamedTuple):
    step: int
    path: str
    manifest: Dict[str, Any]


def checkpoint_step(name: str) -> Optional[int]:
    """The policy step in a ``ckpt_<step>_<rank>.ckpt`` name, else ``None``."""
    m = CKPT_NAME_RE.match(os.path.basename(name))
    return int(m.group(1)) if m else None


def _leaf_paths(node: Any, path: str = "") -> Iterator[str]:
    """Key paths of a tree's leaves as ``jax.tree_util.keystr`` writes them:
    ``['key']`` for a dict entry, ``[i]`` for a list or tuple item, ``.name``
    for a NamedTuple field. ``None`` and empty containers hold no leaf."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in node:
            yield from _leaf_paths(node[k], f"{path}[{k!r}]")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            yield from _leaf_paths(getattr(node, name), f"{path}.{name}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaf_paths(v, f"{path}[{i}]")
    else:
        yield path


def tree_digest(state: Any) -> Tuple[int, str]:
    """(leaf count, short digest of the sorted leaf paths): the JAX
    package's structural digest, computed without JAX."""
    paths = sorted(_leaf_paths(state))
    return len(paths), hashlib.md5("\n".join(paths).encode()).hexdigest()[:12]


def build_manifest(
    *,
    step: int,
    backend: str,
    world_size: int,
    state: Any = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    man: Dict[str, Any] = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "wall_time": time.time(),
        "backend": backend,
        "world_size": int(world_size),
    }
    if state is not None:
        man["leaf_count"], man["tree_digest"] = tree_digest(state)
        if isinstance(state, dict) and isinstance(state.get("batch_size"), int):
            man["batch_size"] = state["batch_size"]
    if extra:
        man.update(extra)
    return man


def manifest_path(ckpt_path: str) -> str:
    return ckpt_path + MANIFEST_SUFFIX


def write_manifest(ckpt_path: str, manifest: Dict[str, Any]) -> str:
    """Atomically write the commit marker of ``ckpt_path``: the last write
    of a save."""
    mpath = manifest_path(ckpt_path)
    d = os.path.dirname(os.path.abspath(mpath))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".manifest-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=0, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return mpath


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """The manifest of ``ckpt_path``, or ``None`` when it is missing or
    unparseable (the checkpoint is not committed)."""
    mpath = manifest_path(ckpt_path)
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) and isinstance(man.get("step"), int) else None


def is_committed(ckpt_path: str) -> bool:
    return read_manifest(ckpt_path) is not None


def committed_checkpoints(ckpt_dir: str) -> List[CommittedCheckpoint]:
    """The committed checkpoints of ``ckpt_dir``, oldest step first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out: List[CommittedCheckpoint] = []
    for entry in os.listdir(ckpt_dir):
        step = checkpoint_step(entry)
        if step is None:
            continue
        path = os.path.join(ckpt_dir, entry)
        man = read_manifest(path)
        if man is not None:
            out.append(CommittedCheckpoint(step, path, man))
    out.sort(key=lambda c: (c.step, c.manifest.get("wall_time", 0.0)))
    return out


def torn_checkpoints(ckpt_dir: str) -> List[str]:
    """Our entries that are not committed: named checkpoints without a valid
    manifest, staging files left by a crashed save, and manifests whose
    checkpoint is gone."""
    if not os.path.isdir(ckpt_dir):
        return []
    torn: List[str] = []
    for entry in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, entry)
        if entry.startswith(TMP_PREFIX) or entry.endswith(".tmp"):
            torn.append(path)
        elif entry.endswith(MANIFEST_SUFFIX):
            if not os.path.exists(path[: -len(MANIFEST_SUFFIX)]):
                torn.append(path)
        elif checkpoint_step(entry) is not None and read_manifest(path) is None:
            torn.append(path)
    return sorted(torn)


def gc_torn(ckpt_dir: str) -> List[str]:
    """Delete the torn writes of ``ckpt_dir``; returns the paths removed.
    Called only where no save is in flight."""
    removed = []
    for path in torn_checkpoints(ckpt_dir):
        try:
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            if os.path.isfile(manifest_path(path)):
                os.remove(manifest_path(path))
            removed.append(path)
        except OSError:
            pass
    return removed
