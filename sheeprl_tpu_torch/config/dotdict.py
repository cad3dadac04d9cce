"""Attribute-access dict used as the composed-config container.

Equivalent role to the reference's ``dotdict`` (sheeprl/utils/utils.py:34-60): after
composition the config becomes a plain recursive dict so framework code is free of any
config-library types.
"""

from __future__ import annotations

from typing import Any, Dict


class dotdict(dict):
    """A dict whose items are also reachable as attributes, recursively."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, dotdict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        other: Dict[str, Any] = dict(*args, **kwargs)
        for k, v in other.items():
            self[k] = v

    def copy(self) -> "dotdict":
        return dotdict({k: v for k, v in self.items()})

    def as_dict(self) -> Dict[str, Any]:
        """Deep-convert back to plain builtin containers (for YAML/ckpt dumps)."""

        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def get_by_path(cfg: dict, path: str, default: Any = ...) -> Any:
    """Fetch ``a.b.c`` from nested dicts; raises KeyError unless a default is given."""
    node: Any = cfg
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
            node = node[int(part)]
        else:
            if default is ...:
                raise KeyError(path)
            return default
    return node


def set_by_path(cfg: dict, path: str, value: Any, *, create: bool = True) -> None:
    parts = path.split(".")
    node: Any = cfg
    for part in parts[:-1]:
        if not isinstance(node, dict):
            raise KeyError(f"cannot descend into non-dict at {part!r} of {path!r}")
        if part not in node:
            if not create:
                raise KeyError(path)
            node[part] = {}
        node = node[part]
    if not create and parts[-1] not in node:
        raise KeyError(
            f"unknown config key {path!r} (use +{path}=... to add a new key)"
        )
    node[parts[-1]] = value
