"""The config engine (port of ``sheeprl_tpu/config``)."""

from sheeprl_tpu_torch.config.compose import (
    MISSING,
    ConfigCompositionError,
    MissingMandatoryValue,
    compose,
    get_class,
    group_options,
    instantiate,
    load_config_file,
    parse_overrides,
    resolve,
)

__all__ = [
    "MISSING",
    "ConfigCompositionError",
    "MissingMandatoryValue",
    "compose",
    "get_class",
    "group_options",
    "instantiate",
    "load_config_file",
    "parse_overrides",
    "resolve",
]
