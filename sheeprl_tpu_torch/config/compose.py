"""Hydra-style YAML config composition (port of
``sheeprl_tpu/config/compose.py``).

The same engine over the port's own copy of the tree,
``sheeprl_tpu_torch/configs`` (each ``_target_: sheeprl_tpu.`` there reads
``_target_: sheeprl_tpu_torch.``), read by the port's YAML reader
(``config/reader.py``, the JAX loader's rules without PyYAML):

- a config *tree* with groups as directories (``algo/``, ``env/``,
  ``exp/``, ``fabric/``, ...);
- ``defaults`` lists: ``- group: name``, ``- /group: name``, ``- override
  /group: name``, ``- group@pkg.path: name``, ``- _self_``, ``name: null``
  to skip, ``name: ???`` to force a CLI choice;
- ``# @package _global_`` headers (exp configs merge at the root);
- CLI overrides: ``group=name``, ``key.path=value``, ``+key=value``,
  ``~key``;
- ``${dotted.path}``, ``${env:NAME,default}`` and ``${now:format}``
  interpolation resolved on the composed tree;
- ``_target_``/``_partial_``/``_args_`` object instantiation: a
  ``_target_`` whose module the port does not have raises
  ``NotImplementedError`` naming ``ROADMAP.md``;
- a search path extendable through ``SHEEPRL_TPU_SEARCH_PATH``
  (``file://`` and ``pkg://`` entries).
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from sheeprl_tpu_torch.config.reader import YAMLError
from sheeprl_tpu_torch.config.reader import load as _yaml_load
from sheeprl_tpu_torch.utils.utils import del_nested, dotdict, set_nested

MISSING = "???"
_SEARCH_PATH_ENV = "SHEEPRL_TPU_SEARCH_PATH"
# modules a _target_ may name that the port must not import
_FOREIGN = ("jax", "flax", "optax", "gymnasium", "yaml", "sheeprl_tpu")


class ConfigCompositionError(Exception):
    pass


class MissingMandatoryValue(ConfigCompositionError):
    pass


# --------------------------------------------------------------------------- #
# Search path
# --------------------------------------------------------------------------- #


def _default_search_path() -> List[str]:
    """Roots searched for config files, in priority order (first hit wins)."""
    paths: List[str] = []
    env = os.environ.get(_SEARCH_PATH_ENV, "")
    for entry in filter(None, (e.strip() for e in env.split(";"))):
        if entry.startswith("file://"):
            paths.append(entry[len("file://") :])
        elif entry.startswith("pkg://"):
            mod = importlib.import_module(entry[len("pkg://") :])
            paths.append(os.path.dirname(mod.__file__))
        else:
            paths.append(entry)
    builtin = os.path.join(os.path.dirname(__file__), "..", "configs")
    paths.append(os.path.abspath(builtin))
    return paths


def _find_config_file(rel: str, search_path: Sequence[str]) -> Optional[str]:
    for root in search_path:
        candidate = os.path.join(root, rel + ".yaml")
        if os.path.isfile(candidate):
            return candidate
        candidate = os.path.join(root, rel + ".yml")
        if os.path.isfile(candidate):
            return candidate
    return None


def group_options(group: str, search_path: Optional[Sequence[str]] = None) -> List[str]:
    """All option names available for a config group (for error messages/CLI)."""
    search_path = list(search_path) if search_path else _default_search_path()
    names: List[str] = []
    for root in search_path:
        d = os.path.join(root, group)
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.endswith((".yaml", ".yml")):
                    names.append(os.path.splitext(f)[0])
    return sorted(set(names))


# --------------------------------------------------------------------------- #
# Overrides
# --------------------------------------------------------------------------- #


@dataclass
class OverrideEntry:
    key: str
    value: Any
    # Bare-word string values with an undotted key *may* be a config-group
    # re-selection (`env=dmc`); composition consumes them as such when the key
    # matches a defaults group, otherwise they fall back to value overrides.
    group_candidate: bool = False


@dataclass
class Overrides:
    values: List[OverrideEntry] = field(default_factory=list)
    additions: List[Tuple[str, Any]] = field(default_factory=list)
    deletions: List[str] = field(default_factory=list)
    consumed_groups: set = field(default_factory=set)

    @property
    def groups(self) -> Dict[str, str]:
        return {e.key: e.value for e in self.values if e.group_candidate}


def parse_overrides(overrides: Sequence[str]) -> Overrides:
    out = Overrides()
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            # hydra allows '~key=value'; the value is advisory — strip it
            out.deletions.append(ov[1:].partition("=")[0])
            continue
        if "=" not in ov:
            raise ConfigCompositionError(f"override {ov!r} is not of the form key=value")
        key, _, raw = ov.partition("=")
        add = key.startswith("+")
        key = key.lstrip("+").lstrip("/")
        try:
            value = _yaml_load(raw) if raw != "" else ""
        except YAMLError:
            value = raw
        if add:
            out.additions.append((key, value))
        else:
            is_group = isinstance(value, str) and bool(value) and "." not in key and "/" not in key
            out.values.append(OverrideEntry(key, value, group_candidate=is_group))
    return out


# --------------------------------------------------------------------------- #
# Defaults-list processing
# --------------------------------------------------------------------------- #

_PKG_RE = re.compile(r"^#\s*@package\s+(\S+)")


def _load_yaml(path: str) -> Tuple[dict, Optional[str]]:
    """Load a yaml file, returning (content, package_directive)."""
    with open(path) as f:
        text = f.read()
    pkg = None
    for line in text.splitlines()[:3]:
        m = _PKG_RE.match(line.strip())
        if m:
            pkg = m.group(1)
            break
    data = _yaml_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigCompositionError(f"config file {path} must contain a mapping")
    return data, pkg


def _merge(dst: dict, src: Mapping) -> dict:
    """Recursive dict merge; ``src`` wins. Lists are replaced, not concatenated."""
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, Mapping):
            _merge(dst[k], v)
        else:
            dst[k] = _copy_tree(v)
    return dst


def _copy_tree(v: Any) -> Any:
    if isinstance(v, Mapping):
        return {k: _copy_tree(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_tree(x) for x in v]
    return v


def _merge_at(dst: dict, package: Optional[str], src: Mapping) -> None:
    if package in (None, "_global_", ""):
        _merge(dst, src)
        return
    node = dst
    for part in package.split("."):
        node = node.setdefault(part, {})
        if not isinstance(node, dict):
            raise ConfigCompositionError(f"package path {package!r} collides with a non-dict value")
    _merge(node, src)


def _parse_default_entry(entry: Any) -> Tuple[Optional[str], Optional[str], Optional[str], bool, bool]:
    """Returns (group, option, package, is_self, is_override)."""
    if entry == "_self_":
        return None, None, None, True, False
    if isinstance(entry, str):
        # bare include of a sibling config file, e.g. "- base"
        return entry, None, None, False, False
    if isinstance(entry, Mapping) and len(entry) == 1:
        key, option = next(iter(entry.items()))
        key = str(key)
        is_override = key.startswith("override ")
        if is_override:
            key = key[len("override ") :].strip()
        package = None
        if "@" in key:
            key, _, package = key.partition("@")
        key = key.lstrip("/")
        return key, (None if option is None else str(option)), package, False, is_override
    raise ConfigCompositionError(f"malformed defaults entry: {entry!r}")


class _Composer:
    def __init__(self, search_path: Sequence[str], overrides: Overrides) -> None:
        self.search_path = list(search_path)
        self.overrides = overrides
        self._loading: List[str] = []  # cycle guard

    def compose_file(self, rel: str, dst: dict, package_override: Optional[str] = None) -> None:
        path = _find_config_file(rel, self.search_path)
        if path is None:
            opts = "\n".join(f"  - {o}" for o in group_options(os.path.dirname(rel), self.search_path))
            raise ConfigCompositionError(
                f"config file {rel!r} not found in search path {self.search_path}"
                + (f"\navailable options:\n{opts}" if opts else "")
            )
        if path in self._loading:
            raise ConfigCompositionError(f"defaults cycle detected at {path}")
        self._loading.append(path)
        try:
            content, pkg = _load_yaml(path)
            package = package_override if package_override is not None else pkg
            if package is None and os.path.dirname(rel):
                package = os.path.dirname(rel).replace("/", ".")
            defaults = content.pop("defaults", None)
            own_merged = False
            if defaults is not None:
                if not isinstance(defaults, list):
                    raise ConfigCompositionError(f"'defaults' in {path} must be a list")
                for entry in defaults:
                    group, option, entry_pkg, is_self, is_override = _parse_default_entry(entry)
                    if is_self:
                        _merge_at(dst, package, content)
                        own_merged = True
                        continue
                    if isinstance(entry, str):
                        # sibling include (e.g. `- default` inside env/dummy.yaml):
                        # not a group, never overridable from the CLI
                        rel_dir = os.path.dirname(rel)
                        sibling = os.path.join(rel_dir, group) if rel_dir else group
                        self.compose_file(sibling, dst, package_override=package)
                        continue
                    chosen = self._choice(group)
                    if chosen is not None:
                        option = chosen
                    if option is None:
                        # `- group: null` → explicitly skipped unless overridden
                        continue
                    if option == MISSING:
                        raise MissingMandatoryValue(
                            f"you must specify '{group}=<option>'; available options:\n"
                            + "\n".join(f"  - {o}" for o in group_options(group, self.search_path))
                        )
                    # `@pkg` in a defaults entry is relative to this file's
                    # package (hydra semantics: metric/default.yaml's
                    # `/logger@logger` lands at metric.logger); `_global_...`
                    # prefixes make it absolute.
                    eff_pkg = entry_pkg
                    if entry_pkg is not None:
                        if entry_pkg == "_global_":
                            eff_pkg = "_global_"
                        elif entry_pkg.startswith("_global_."):
                            eff_pkg = entry_pkg[len("_global_.") :]
                        elif package not in (None, "_global_", ""):
                            eff_pkg = f"{package}.{entry_pkg}"
                    if is_override:
                        # hydra semantics: `override /group: opt` REPLACES the
                        # earlier selection — drop what that group already
                        # merged so stale keys from the old option cannot leak.
                        clear_at = eff_pkg if eff_pkg is not None else group.replace("/", ".")
                        if clear_at not in (None, "_global_", ""):
                            node: Any = dst
                            parts = clear_at.split(".")
                            for part in parts[:-1]:
                                node = node.get(part, {}) if isinstance(node, dict) else {}
                            if isinstance(node, dict):
                                node.pop(parts[-1], None)
                    self.compose_file(
                        os.path.join(group, option),
                        dst,
                        package_override=eff_pkg,
                    )
            if not own_merged:
                _merge_at(dst, package, content)
        finally:
            self._loading.pop()

    def _choice(self, group: str) -> Optional[str]:
        if group in self.overrides.groups:
            self.overrides.consumed_groups.add(group)
            return self.overrides.groups[group]
        return None


# --------------------------------------------------------------------------- #
# Interpolation
# --------------------------------------------------------------------------- #

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: Mapping, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, Mapping) and part in node:
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise KeyError(dotted)
    return node


def _resolve_value(root: Mapping, value: Any, stack: Tuple[str, ...]) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value)
        if full:
            return _resolve_ref(root, full.group(1).strip(), stack)

        def sub(m: re.Match) -> str:
            return str(_resolve_ref(root, m.group(1).strip(), stack))

        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_ref(root: Mapping, expr: str, stack: Tuple[str, ...]) -> Any:
    if expr.startswith("env:"):
        name, sep, default = expr[4:].partition(",")
        name = name.strip()
        if name in os.environ:
            return os.environ[name]
        if not sep:
            raise ConfigCompositionError(f"environment variable {name!r} is not set and no default was given")
        return _yaml_load(default)
    if expr.startswith("now:"):
        import datetime

        return datetime.datetime.now().strftime(expr[4:] or "%Y-%m-%d_%H-%M-%S")
    if expr in stack:
        raise ConfigCompositionError(f"interpolation cycle: {' -> '.join(stack + (expr,))}")
    try:
        target = _lookup(root, expr)
    except (KeyError, IndexError, ValueError):
        raise ConfigCompositionError(f"interpolation key {expr!r} not found") from None
    return _resolve_tree(root, target, stack + (expr,)) if isinstance(target, (str, Mapping, list)) else target


def _resolve_tree(root: Mapping, node: Any, stack: Tuple[str, ...] = ()) -> Any:
    if isinstance(node, Mapping):
        return {k: _resolve_tree(root, v, stack) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(root, v, stack) for v in node]
    return _resolve_value(root, node, stack)


def resolve(cfg: Mapping) -> dict:
    return _resolve_tree(cfg, cfg)


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    search_path: Optional[Sequence[str]] = None,
    interpolate: bool = True,
) -> dotdict:
    """Compose a config tree the way ``hydra.main`` would."""
    ovs = parse_overrides(overrides or [])
    sp = list(search_path) if search_path else _default_search_path()
    composer = _Composer(sp, ovs)
    out: dict = {}
    composer.compose_file(config_name, out)
    for entry in ovs.values:
        if entry.group_candidate and entry.key in ovs.consumed_groups:
            continue  # consumed as a group re-selection during composition
        if not _has_nested(out, entry.key):
            raise ConfigCompositionError(
                f"could not override {entry.key!r}: no such key in the composed config "
                f"(use '+{entry.key}={entry.value}' to add a new key)"
            )
        set_nested(out, entry.key, entry.value)
    for key, value in ovs.additions:
        try:
            set_nested(out, key, value)
        except KeyError as e:
            raise ConfigCompositionError(str(e)) from None
    for key in ovs.deletions:
        try:
            del_nested(out, key)
        except (KeyError, TypeError):
            raise ConfigCompositionError(f"cannot delete missing key {key!r}") from None
    _check_missing(out, prefix="")
    if interpolate:
        out = resolve(out)
    return dotdict(out)


def compose_group(group: str, option: str, search_path: Optional[Sequence[str]] = None) -> dict:
    """Compose a single config group's subtree (``<group>/<option>.yaml``
    with its sibling-include defaults) and return just that subtree.

    Used by the eval/registration CLIs, whose base config comes from a
    checkpoint's ``config.yaml`` rather than full composition: a
    ``group=option`` override there must re-compose the group the way
    ``hydra`` would, not assign the bare string."""
    sp = list(search_path) if search_path else _default_search_path()
    composer = _Composer(sp, Overrides())
    out: dict = {}
    composer.compose_file(os.path.join(group, option), out)
    return out.get(group, out)


def _has_nested(d: Mapping, dotted: str) -> bool:
    node: Any = d
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return False
        node = node[part]
    return True


def _check_missing(node: Any, prefix: str) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _check_missing(v, f"{prefix}{k}.")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _check_missing(v, f"{prefix}{i}.")
    elif node == MISSING:
        raise MissingMandatoryValue(f"mandatory value {prefix[:-1]!r} is missing — set it on the command line")


def instantiate(node: Any, *args: Any, _recursive_: bool = True, **kwargs: Any) -> Any:
    """Build an object from a ``_target_`` node (hydra.utils.instantiate-alike).

    Usage sites: the fabric node (``cli.run_algorithm``), the metric
    aggregator (``utils/metric.py``).
    """
    if not isinstance(node, Mapping) or "_target_" not in node:
        raise ConfigCompositionError(f"instantiate() requires a mapping with '_target_', got {node!r}")
    spec = dict(node)
    target = spec.pop("_target_")
    partial = bool(spec.pop("_partial_", False))
    pos = list(spec.pop("_args_", [])) + list(args)
    if _recursive_:
        spec = {k: _instantiate_tree(v) for k, v in spec.items()}
        pos = [_instantiate_tree(v) for v in pos]
    spec.update(kwargs)
    obj = get_class(target)
    if partial:
        return functools.partial(obj, *pos, **spec)
    return obj(*pos, **spec)


def _instantiate_tree(v: Any) -> Any:
    """Recursively build every ``_target_`` node at any depth (hydra recurses
    through nested dicts and lists alike)."""
    if isinstance(v, Mapping):
        if "_target_" in v:
            return instantiate(v)
        return {k: _instantiate_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_instantiate_tree(x) for x in v)
    return v


def get_class(target: str) -> Any:
    """The object a dotted ``_target_`` names; ``NotImplementedError`` when
    the port has no such module or attribute (or it is one the port must
    not import)."""
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ConfigCompositionError(f"invalid _target_ {target!r}")
    not_ported = NotImplementedError(
        f"_target_ {target!r} is not ported to sheeprl_tpu_torch yet: it is queued in ROADMAP.md"
    )
    if module_name.split(".")[0] in _FOREIGN:
        raise not_ported
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name is not None and module_name.startswith(e.name):
            raise not_ported from None
        raise
    if not hasattr(module, attr):
        raise not_ported
    return getattr(module, attr)


def load_config_file(path: str) -> dotdict:
    """A stored run config (``config.yaml`` beside a run's checkpoints):
    the port writes it as JSON, the JAX package as ``yaml.safe_dump``."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text)
    except ValueError:
        raw = _yaml_load(text)
    if not isinstance(raw, dict):
        raise ConfigCompositionError(f"{path} does not hold a mapping")
    return dotdict(raw)
