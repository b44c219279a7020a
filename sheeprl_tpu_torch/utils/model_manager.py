"""The model registry (port of ``sheeprl_tpu/utils/model_manager.py``).

- :class:`LocalModelManager`: a file-backed registry, ``registry.json``
  with the version records and one copy of each version's artifact under
  ``<registry_dir>/<model_name>/v<version>/``, the JAX package's layout
  and records;
- ``model_manager.backend=mlflow``: MLflow's registry. The port does not
  use mlflow (it is installed neither here nor on the card's machine), so
  the backend raises ``ModuleNotFoundError`` naming mlflow, which is what
  the JAX package raises where mlflow is absent.

Logging a model is pickling one sub-tree of a checkpoint (numpy arrays in
the JAX package's layout: the port's checkpoints hold the same trees) to an
artifact file; ``log_models_from_checkpoint`` is the shared body of each
algorithm's hook over its ``MODELS_TO_REGISTER``.
"""

from __future__ import annotations

import getpass
import json
import os
import pickle
import shutil
from abc import ABC, abstractmethod
from datetime import datetime
from typing import Any, Callable, Dict, Iterable, Optional

VERSION_MD_TEMPLATE = "## **Version {}**\n"
DESCRIPTION_MD_TEMPLATE = "### Description: \n{}\n"


class AbstractModelManager(ABC):
    """The model-manager interface."""

    def __init__(self, fabric: Any) -> None:
        self.fabric = fabric

    @abstractmethod
    def register_model(
        self, model_location: str, model_name: str, description: Optional[str] = None, tags: Optional[Dict] = None
    ) -> Any:
        """Register a model artifact in the registry."""

    @abstractmethod
    def get_latest_version(self, model_name: str) -> Any:
        """The latest registered version of a model."""

    @abstractmethod
    def transition_model(self, model_name: str, version: int, stage: str, description: Optional[str] = None) -> Any:
        """Move a model version to a new stage."""

    @abstractmethod
    def delete_model(self, model_name: str, version: int, description: Optional[str] = None) -> None:
        """Delete a model version."""

    @abstractmethod
    def download_model(self, model_name: str, version: int, output_path: str) -> None:
        """Copy a model version's artifact to ``output_path``."""


def _author_and_date() -> str:
    try:
        author = getpass.getuser()
    except Exception:
        author = "unknown"
    return f"**Author**: {author}\n**Date**: {datetime.now().strftime('%d/%m/%Y %H:%M:%S')}\n"


class LocalModelManager(AbstractModelManager):
    """File-backed registry: ``<registry_dir>/registry.json`` holds the
    version records; artifacts are copied to
    ``<registry_dir>/<model_name>/v<version>/``."""

    def __init__(self, fabric: Any, registry_dir: str) -> None:
        super().__init__(fabric)
        self.registry_dir = registry_dir
        os.makedirs(registry_dir, exist_ok=True)
        self._index_path = os.path.join(registry_dir, "registry.json")

    def _load_index(self) -> Dict[str, Any]:
        if os.path.isfile(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {}

    def _save_index(self, index: Dict[str, Any]) -> None:
        with open(self._index_path, "w") as f:
            json.dump(index, f, indent=2)

    def register_model(
        self, model_location: str, model_name: str, description: Optional[str] = None, tags: Optional[Dict] = None
    ) -> Dict[str, Any]:
        index = self._load_index()
        versions = index.setdefault(model_name, [])
        version = len(versions) + 1
        dst_dir = os.path.join(self.registry_dir, model_name, f"v{version}")
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, os.path.basename(model_location))
        shutil.copy2(model_location, dst)
        changelog = VERSION_MD_TEMPLATE.format(version) + _author_and_date() + DESCRIPTION_MD_TEMPLATE.format(description or "")
        record = {
            "version": version,
            "artifact": dst,
            "stage": "None",
            "description": description or "",
            "tags": tags or {},
            "changelog": changelog,
        }
        versions.append(record)
        self._save_index(index)
        print(f"Registered model {model_name} with version {version}")
        return record

    def get_latest_version(self, model_name: str) -> Dict[str, Any]:
        versions = self._load_index().get(model_name, [])
        if not versions:
            raise KeyError(f"no registered versions for model {model_name!r}")
        return versions[-1]

    def transition_model(self, model_name: str, version: int, stage: str, description: Optional[str] = None) -> Dict[str, Any]:
        index = self._load_index()
        record = index[model_name][version - 1]
        record["stage"] = stage
        if description:
            record["changelog"] += DESCRIPTION_MD_TEMPLATE.format(description)
        self._save_index(index)
        return record

    def delete_model(self, model_name: str, version: int, description: Optional[str] = None) -> None:
        index = self._load_index()
        record = index[model_name][version - 1]
        artifact_dir = os.path.dirname(record["artifact"])
        if os.path.isdir(artifact_dir):
            shutil.rmtree(artifact_dir)
        record["stage"] = "Deleted"
        record["artifact"] = None
        self._save_index(index)

    def download_model(self, model_name: str, version: int, output_path: str) -> None:
        record = self._load_index()[model_name][version - 1]
        if not record["artifact"]:
            raise FileNotFoundError(f"model {model_name} v{version} was deleted")
        os.makedirs(output_path, exist_ok=True)
        shutil.copy2(record["artifact"], output_path)


def make_model_manager(fabric: Any, cfg: Dict[str, Any]) -> AbstractModelManager:
    """The configured backend (``model_manager.backend``)."""
    mm = cfg["model_manager"]
    backend = str(mm.get("backend", "local")).lower()
    if backend == "mlflow":
        tracking_uri = mm.get("tracking_uri") or os.getenv("MLFLOW_TRACKING_URI")
        if not tracking_uri:
            raise ValueError("model_manager.backend=mlflow needs model_manager.tracking_uri or MLFLOW_TRACKING_URI")
        raise ModuleNotFoundError("mlflow is not installed; use the 'local' model-manager backend instead")
    if backend == "local":
        return LocalModelManager(fabric, mm.get("registry_dir") or "models_registry")
    raise ValueError(f"unknown model_manager backend {backend!r} (choose 'local' or 'mlflow')")


def log_models_from_checkpoint(state: Dict[str, Any], keys: Iterable[str], artifacts_dir: str) -> Dict[str, str]:
    """Pickle each registered sub-model's checkpoint tree into
    ``artifacts_dir``; keys nested under a top-level ``agent`` dict (the PPO
    and SAC checkpoints) are looked up there. A key the checkpoint lacks
    (P2E finetuning has no ensembles) is skipped: registration checks that
    the configured models exist."""
    os.makedirs(artifacts_dir, exist_ok=True)
    out: Dict[str, str] = {}
    for k in keys:
        if k in state:
            tree = state[k]
        elif isinstance(state.get("agent"), dict) and k in state["agent"]:
            tree = state["agent"][k]
        else:
            continue
        path = os.path.join(artifacts_dir, f"{k}.pkl")
        with open(path, "wb") as f:
            pickle.dump(tree, f, protocol=pickle.HIGHEST_PROTOCOL)
        out[k] = path
    return out


def make_log_models(models_to_register: Iterable[str]) -> Callable[[Any, Dict[str, Any], Dict[str, Any], str], Dict[str, str]]:
    """An algorithm's ``log_models_from_checkpoint(fabric, cfg, state,
    artifacts_dir)`` over its ``MODELS_TO_REGISTER``."""
    keys = sorted(models_to_register)

    def log_models_from_checkpoint_(fabric: Any, cfg: Dict[str, Any], state: Dict[str, Any], artifacts_dir: str) -> Dict[str, str]:
        return log_models_from_checkpoint(state, keys, artifacts_dir)

    log_models_from_checkpoint_.__name__ = "log_models_from_checkpoint"
    return log_models_from_checkpoint_


def register_model_from_checkpoint(
    fabric: Any, cfg: Dict[str, Any], state: Dict[str, Any], log_models_fn: Callable[..., Dict[str, str]]
) -> Dict[str, Any]:
    """Log the checkpoint's sub-models and register the configured subset."""
    artifacts_dir = os.path.join(cfg["model_manager"].get("registry_dir") or "models_registry", "_artifacts", cfg["exp_name"])
    models_info = log_models_fn(fabric, cfg, state, artifacts_dir)
    manager = make_model_manager(fabric, cfg)
    wanted = set(cfg["model_manager"]["models"].keys())
    if not wanted.issubset(models_info.keys()):
        raise RuntimeError(
            f"The models you want to register must be a subset of the models of the {cfg['algo']['name']} "
            f"agent.\nModels specified in the configs: {sorted(wanted)}."
            f"\nModels of the agent: {sorted(models_info)}."
        )
    registered = {}
    for k, cfg_model in cfg["model_manager"]["models"].items():
        registered[k] = manager.register_model(models_info[k], cfg_model["model_name"], cfg_model.get("description"), cfg_model.get("tags"))
    return registered
