from sheeprl_tpu_torch.config.composer import (
    Composer,
    ConfigError,
    MissingMandatoryValue,
    compose,
    deep_merge,
    explicit_overrides,
    repoint_targets,
    yaml_load,
)
from sheeprl_tpu_torch.config.dotdict import dotdict, get_by_path, set_by_path
from sheeprl_tpu_torch.config.instantiate import instantiate, locate

__all__ = [
    "Composer",
    "ConfigError",
    "MissingMandatoryValue",
    "compose",
    "deep_merge",
    "explicit_overrides",
    "repoint_targets",
    "yaml_load",
    "dotdict",
    "get_by_path",
    "set_by_path",
    "instantiate",
    "locate",
]
