"""The port's config tree (a copy of ``sheeprl_tpu/configs`` whose
``_target_``s name ``sheeprl_tpu_torch``) and the Dreamer-V3 presets over
it.

``compose(size, env=..., overrides=...)`` composes ``exp=dreamer_v3``,
``algo=dreamer_v3_<size>`` and the env's group through the config engine
(``sheeprl_tpu_torch.config``), sets the dotted ``overrides`` (Python
values, such as ``{"env.num_envs": 1}``) and resolves the ``${...}``
references last, so an override feeds every reference to it. The precision
is ``bf16-mixed``, as ``configs/fabric/default.yaml`` composes it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from sheeprl_tpu_torch.config.compose import _has_nested, compose as compose_tree, resolve
from sheeprl_tpu_torch.utils.utils import dotdict, set_nested

SIZES = ("XS", "S", "M", "L", "XL")

# preset name -> (env group, env.id): the envs the port's factory builds
ENVS: Dict[str, tuple] = {
    "pixel_catcher": ("pixel_catcher", "pixel_catcher"),
    "pixel_pendulum": ("pixel_pendulum", "PixelPendulum-v0"),
    "pixel_pointmass": ("pixel_pointmass", "PixelPointmass-v0"),
    "dummy_discrete": ("dummy", "dummy_discrete"),
    "dummy_continuous": ("dummy", "dummy_continuous"),
}


def compose(size: str = "S", env: str = "pixel_catcher", overrides: Optional[Mapping[str, Any]] = None) -> dotdict:
    """The Dreamer-V3 config at ``size`` on ``env`` with dotted
    ``overrides`` such as ``{"env.num_envs": 1}``."""
    if size not in SIZES:
        raise ValueError(f"unknown Dreamer-V3 size {size!r}; one of {SIZES}")
    if env not in ENVS:
        raise ValueError(f"unknown env preset {env!r}; one of {tuple(ENVS)}")
    group, env_id = ENVS[env]
    tree = compose_tree(
        "config", ["exp=dreamer_v3", f"algo=dreamer_v3_{size}", f"env={group}", f"env.id={env_id}"], interpolate=False
    )
    for key, value in (overrides or {}).items():
        if not _has_nested(tree, key):
            raise KeyError(f"no config key {key!r}")
        set_nested(tree, key, value)
    return dotdict(resolve(tree))
