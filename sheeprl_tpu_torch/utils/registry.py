"""Algorithm and evaluation registries (port of
``sheeprl_tpu/utils/registry.py``, the same contract and errors).

Algorithms register at import time through the decorators; the CLI imports
the ported algorithm modules (``cli.ALGORITHM_MODULES``) and looks the
entry point up by ``cfg.algo.name``. ``decoupled=True`` marks player and
trainer topologies that manage their own process roles.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

# {module_name: [{"name": algo_name, "entrypoint": fn_name, "decoupled": bool}]}
algorithm_registry: Dict[str, List[Dict[str, Any]]] = {}
evaluation_registry: Dict[str, List[Dict[str, Any]]] = {}


def _algo_name(module: str) -> str:
    # algorithms live at sheeprl_tpu_torch.algos.<name>.<file>; the registered
    # name is the module file's name (dreamer_v3/dreamer_v3.py -> "dreamer_v3")
    return module.split(".")[-1]


def _register(registry: Dict[str, List[Dict[str, Any]]], fn: Callable, decoupled: bool = False) -> Callable:
    module = fn.__module__
    entry = {"name": _algo_name(module), "entrypoint": fn.__name__, "decoupled": decoupled}
    registered = registry.setdefault(module, [])
    if any(e["name"] == entry["name"] and e["entrypoint"] == entry["entrypoint"] for e in registered):
        raise ValueError(f"{entry['name']}.{entry['entrypoint']} already registered")
    registered.append(entry)
    return fn


def register_algorithm(decoupled: bool = False) -> Callable:
    def wrap(fn: Callable) -> Callable:
        return _register(algorithm_registry, fn, decoupled)

    return wrap


def register_evaluation(algorithms: str | List[str]) -> Callable:
    algos = [algorithms] if isinstance(algorithms, str) else list(algorithms)

    def wrap(fn: Callable) -> Callable:
        module = fn.__module__
        registered = evaluation_registry.setdefault(module, [])
        for name in algos:
            # cross-check: an evaluation must refer to a registered algorithm
            known = {e["name"] for entries in algorithm_registry.values() for e in entries}
            if name not in known:
                raise ValueError(
                    f"cannot register evaluation for unknown algorithm {name!r}; "
                    f"known algorithms: {sorted(known)}"
                )
            registered.append({"name": name, "entrypoint": fn.__name__})
        return fn

    return wrap


def find_algorithm(algo_name: str) -> Dict[str, Any]:
    for module, entries in algorithm_registry.items():
        for entry in entries:
            if entry["name"] == algo_name:
                return {"module": module, **entry}
    known = sorted({e["name"] for entries in algorithm_registry.values() for e in entries})
    raise ValueError(f"unknown algorithm {algo_name!r}; registered algorithms: {known}")


def find_evaluation(algo_name: str) -> Dict[str, Any]:
    for module, entries in evaluation_registry.items():
        for entry in entries:
            if entry["name"] == algo_name:
                return {"module": module, **entry}
    known = sorted({e["name"] for entries in evaluation_registry.values() for e in entries})
    raise ValueError(f"no registered evaluation for {algo_name!r}; available: {known}")
