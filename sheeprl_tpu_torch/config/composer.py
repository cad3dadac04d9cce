"""Self-contained YAML config composition (port of ``sheeprl_tpu/config/composer.py``).

The same composition rules as the JAX package's composer, over the port's own
config tree (``sheeprl_tpu_torch/configs``):

- a root ``config.yaml`` with a ``defaults`` list of config *groups* (``algo: default``),
  composed in order with ``_self_`` marking where the root body merges;
- experiment files (``exp/*.yaml``) that are global overlays and may themselves carry a
  ``defaults`` list with ``override /group: option`` entries;
- dotted CLI overrides ``a.b.c=value`` (YAML-typed), group selection ``group=option``,
  additions ``+a.b=value`` and deletions ``~a.b``;
- ``${a.b.c}`` interpolation (whole-value refs keep their type; embedded refs become
  strings) plus ``${now:FORMAT}`` timestamps and ``${oc.env:VAR,default}`` env reads;
- a search-path extension hook via ``SHEEPRL_SEARCH_PATH`` (``;``-separated directories,
  ``file://`` prefix allowed) so user config trees can shadow/extend the builtin one.
"""

from __future__ import annotations

import datetime
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

from sheeprl_tpu_torch.config.dotdict import dotdict, get_by_path, set_by_path

_BUILTIN_CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"
_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class ConfigError(Exception):
    pass


class MissingMandatoryValue(ConfigError):
    pass


def _search_dirs(extra: Optional[Sequence[os.PathLike]] = None) -> List[Path]:
    """User dirs (SHEEPRL_SEARCH_PATH) shadow the builtin tree, like the reference's
    search-path plugin (hydra_plugins/sheeprl_search_path.py:23-32)."""
    dirs: List[Path] = []
    env = os.environ.get("SHEEPRL_SEARCH_PATH", "")
    for entry in [e for e in env.split(";") if e.strip()]:
        entry = entry.strip()
        if entry.startswith("file://"):
            entry = entry[len("file://") :]
        if entry.startswith("pkg://"):
            # pkg://a.b.c → site dir of that package
            mod = entry[len("pkg://") :].replace(".", "/")
            for root in map(Path, __import__("sys").path):
                if (root / mod).is_dir():
                    dirs.append(root / mod)
                    break
            continue
        dirs.append(Path(entry))
    if extra:
        dirs.extend(Path(e) for e in extra)
    dirs.append(_BUILTIN_CONFIG_DIR)
    return [d for d in dirs if d.is_dir()]


def _find_config(group: str, name: str, dirs: List[Path]) -> Optional[Path]:
    name = str(name)
    if not name.endswith(".yaml"):
        name += ".yaml"
    for d in dirs:
        p = d / group / name if group else d / name
        if p.is_file():
            return p
    return None


class _SciFloatLoader(yaml.SafeLoader):
    """SafeLoader that also resolves '1e-3'-style scalars as floats (YAML 1.1 only
    accepts '1.0e-3'), matching what hydra/omegaconf users expect."""


_SciFloatLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(stream: Any) -> Any:
    return yaml.load(stream, Loader=_SciFloatLoader)


def _load_yaml(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml_load(f)
    return data or {}


def deep_merge(base: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``other`` into ``base`` (returns base). Dicts merge recursively; any other
    value (including lists) replaces."""
    for k, v in other.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _parse_defaults(defaults: List[Any]) -> List[Tuple[str, Any, bool]]:
    """Normalize a defaults list to [(group, option, is_override)]; '_self_' becomes
    ('_self_', None, False)."""
    out: List[Tuple[str, Any, bool]] = []
    for entry in defaults or []:
        if entry == "_self_":
            out.append(("_self_", None, False))
        elif isinstance(entry, str):
            # bare base ref (e.g. `- dreamer_v3` inside an exp/algo file)
            out.append((entry, None, False))
        elif isinstance(entry, dict):
            (key, val), = entry.items()
            override = False
            key = str(key)
            if key.startswith("override "):
                override = True
                key = key[len("override ") :]
            key = key.strip().lstrip("/")
            out.append((key, val, override))
        else:
            raise ConfigError(f"unsupported defaults entry: {entry!r}")
    return out


class Composer:
    def __init__(self, extra_dirs: Optional[Sequence[os.PathLike]] = None) -> None:
        self.dirs = _search_dirs(extra_dirs)

    def available(self, group: str) -> List[str]:
        names: List[str] = []
        for d in self.dirs:
            g = d / group
            if g.is_dir():
                names.extend(p.stem for p in g.glob("*.yaml"))
        return sorted(set(names))

    def compose(self, overrides: Sequence[str] = (), config_name: str = "config") -> dotdict:
        group_sel, dotted, additions, deletions = self._split_overrides(overrides)

        root_path = _find_config("", config_name, self.dirs)
        if root_path is None:
            raise ConfigError(f"root config {config_name!r} not found in {self.dirs}")
        root = _load_yaml(root_path)
        defaults = _parse_defaults(root.pop("defaults", []))

        # CLI group selections override the root defaults list.
        defaults = [
            ("_self_", None, False) if g == "_self_" else (g, group_sel.get(g, opt), ov)
            for g, opt, ov in defaults
        ]
        known_groups = {g for g, _, _ in defaults if g != "_self_"}
        for g, opt in group_sel.items():
            if g not in known_groups:
                defaults.append((g, opt, False))

        cfg: Dict[str, Any] = {}
        self._compose_defaults(cfg, defaults, root_body=root, group_sel=group_sel)

        for path, value in dotted.items():
            set_by_path(cfg, path, value, create=False)
        for path, value in additions.items():
            set_by_path(cfg, path, value, create=True)
        for path in deletions:
            try:
                parent = get_by_path(cfg, ".".join(path.split(".")[:-1])) if "." in path else cfg
                parent.pop(path.split(".")[-1], None)
            except KeyError:
                pass

        cfg = resolve_interpolations(cfg)
        _check_mandatory(cfg)
        return dotdict(cfg)

    # -- internals ---------------------------------------------------------------

    def _compose_defaults(
        self,
        cfg: Dict[str, Any],
        defaults: List[Tuple[str, Any, bool]],
        root_body: Dict[str, Any],
        group_sel: Dict[str, str],
    ) -> None:
        # First pass: let 'exp' (or any global overlay) rewrite earlier group choices via
        # its own `override /group: option` defaults.
        resolved: List[Tuple[str, Any]] = []
        overlay_bodies: List[Dict[str, Any]] = []
        pending = list(defaults)
        overrides_from_overlays: Dict[str, Any] = {}
        for group, option, _ in pending:
            if group == "_self_":
                resolved.append(("_self_", None))
                continue
            if option is None or option == "???":
                if group in ("exp",):
                    raise MissingMandatoryValue(
                        "You must specify an experiment: e.g. `exp=ppo` "
                        f"(available: {', '.join(self.available('exp'))})"
                    )
                continue
            if group == "exp" or self._is_global_overlay(group, option):
                body, overlay_overrides = self._load_overlay(group, option)
                for g2, o2 in overlay_overrides:
                    overrides_from_overlays[g2] = group_sel.get(g2, o2)
                overlay_bodies.append(body)
            else:
                resolved.append((group, option))

        for group, option in resolved:
            if group == "_self_":
                deep_merge(cfg, root_body)
                continue
            option = overrides_from_overlays.pop(group, option)
            self._merge_group(cfg, group, option)
        # groups introduced only by the overlay
        for group, option in overrides_from_overlays.items():
            self._merge_group(cfg, group, option)
        for body in overlay_bodies:
            deep_merge(cfg, body)

    def _is_global_overlay(self, group: str, option: Any) -> bool:
        path = _find_config(group, option, self.dirs)
        if path is None:
            return False
        with open(path) as f:
            head = f.readline()
        return "@package _global_" in head

    def _load_overlay(
        self, group: str, option: Any, _depth: int = 0
    ) -> Tuple[Dict[str, Any], List[Tuple[str, Any]]]:
        """Load a ``@package _global_`` overlay (an exp file). Returns (body, overrides)
        where overrides is a list of (group, option) selections the overlay forces on the
        root defaults (``override /algo: ppo``). Overlays may inherit other overlays of
        the same group via a bare ``- name`` defaults entry."""
        if _depth > 10:
            raise ConfigError(f"overlay recursion too deep at {group}/{option}")
        path = _find_config(group, option, self.dirs)
        if path is None:
            raise ConfigError(
                f"config '{group}/{option}' not found; available: {self.available(group)}"
            )
        body = _load_yaml(path)
        sub_defaults = _parse_defaults(body.pop("defaults", []))
        merged: Dict[str, Any] = {}
        overrides: List[Tuple[str, Any]] = []
        for g, o, is_override in sub_defaults:
            if g == "_self_":
                continue
            if is_override:
                overrides.append((g, o))
            elif o is None:
                base_body, base_overrides = self._load_overlay(group, g, _depth + 1)
                deep_merge(merged, base_body)
                overrides = base_overrides + overrides
            elif "@" in g:
                src, _, pkg = g.partition("@")
                sub = self._load_group_node(src.rstrip("/"), o)
                if pkg != "_global_":
                    for part in reversed(pkg.split(".")):
                        sub = {part: sub}
                deep_merge(merged, sub)
            else:
                overrides.append((g, o))
        deep_merge(merged, body)
        return merged, overrides

    def _merge_group(self, cfg: Dict[str, Any], group: str, option: Any) -> None:
        if option is None:
            return
        node = self._load_group_node(group, option)
        deep_merge(cfg, {group: node} if group != "_global_" else node)

    def _load_group_node(self, group: str, option: Any, _depth: int = 0) -> Dict[str, Any]:
        """Load ``group/option.yaml``, recursively resolving its ``defaults`` list.

        Supported defaults entries inside a group file:
          - ``_self_`` — merge point for the file body;
          - ``name`` (bare, via {name: null}? no — expressed as ``- name: null``)…
            practically: ``- default`` style sugar is written as ``{default: null}`` by
            YAML, so a null option means "option of the same group named <key>";
          - ``other_option`` of the same group (inheritance), e.g. ``- dreamer_v3``;
          - ``/other_group@package: option`` — load another group's option under
            ``package`` inside this node (the reference's ``/optim@optimizer: adam``).
        """
        if _depth > 10:
            raise ConfigError(f"defaults recursion too deep at {group}/{option}")
        path = _find_config(group, option, self.dirs)
        if path is None:
            raise ConfigError(
                f"config '{group}/{option}' not found; available: {self.available(group)}"
            )
        body = _load_yaml(path)
        raw_defaults = body.pop("defaults", [])
        node: Dict[str, Any] = {}
        merged_self = False
        for entry in raw_defaults or []:
            if entry == "_self_":
                deep_merge(node, body)
                merged_self = True
                continue
            if isinstance(entry, str):
                # bare string: an option of the same group used as a base
                deep_merge(node, self._load_group_node(group, entry, _depth + 1))
                continue
            (key, val), = entry.items()
            key = str(key).strip().lstrip("/")
            if "@" in key:
                src, _, pkg = key.partition("@")
                sub = self._load_group_node(src.rstrip("/"), val, _depth + 1)
                if pkg != "_global_":
                    # dotted packages nest (`/optim@actor.optimizer: adam`)
                    for part in reversed(pkg.split(".")):
                        sub = {part: sub}
                deep_merge(node, sub)
            elif val is None:
                deep_merge(node, self._load_group_node(group, key, _depth + 1))
            else:
                deep_merge(node, self._load_group_node(key, val, _depth + 1))
        if not merged_self:
            deep_merge(node, body)
        return node

    def _is_group(self, name: str) -> bool:
        return any((d / name).is_dir() for d in self.dirs)

    def _split_overrides(
        self,
        overrides: Sequence[str],
    ) -> Tuple[Dict[str, str], Dict[str, Any], Dict[str, Any], List[str]]:
        group_sel: Dict[str, str] = {}
        dotted: Dict[str, Any] = {}
        additions: Dict[str, Any] = {}
        deletions: List[str] = []
        for raw in overrides:
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("~"):
                deletions.append(raw[1:])
                continue
            if "=" not in raw:
                raise ConfigError(f"override {raw!r} is not of the form key=value")
            key, value = raw.split("=", 1)
            is_add = key.startswith("+")
            key = key.lstrip("+")
            parsed = yaml_load(value) if value != "" else None
            if is_add:
                additions[key] = parsed
            elif "." not in key and self._is_group(key):
                # bare `group=option`: group selection (a dir of that name exists)
                group_sel[key] = value
            else:
                dotted[key] = parsed
        return group_sel, dotted, additions, deletions


def resolve_interpolations(cfg: Dict[str, Any]) -> Dict[str, Any]:
    def resolve_value(value: Any, depth: int = 0) -> Any:
        if depth > 20:
            raise ConfigError("interpolation loop detected")
        if isinstance(value, str):
            m = _INTERP_RE.fullmatch(value.strip())
            if m:
                return resolve_ref(m.group(1), depth)
            def sub(match: "re.Match[str]") -> str:
                return str(resolve_ref(match.group(1), depth))
            return _INTERP_RE.sub(sub, value)
        if isinstance(value, dict):
            return {k: resolve_value(v, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve_value(v, depth) for v in value]
        return value

    def resolve_ref(ref: str, depth: int) -> Any:
        ref = ref.strip()
        if ref.startswith("now:"):
            return datetime.datetime.now().strftime(ref[len("now:") :])
        if ref.startswith("oc.env:") or ref.startswith("env:"):
            body = ref.split(":", 1)[1]
            var, _, default = body.partition(",")
            var = var.strip()
            if var in os.environ:
                return os.environ[var]
            # YAML-style scalars in the DEFAULT position keep their type (null/bool/
            # int/float); a set env var always passes through as a raw string
            # (OmegaConf parity: ${oc.env:VAR,null} -> None only when VAR is unset)
            default = default.strip()
            if default in ("null", "None"):
                return None
            if default in ("true", "false"):
                return default == "true"
            # YAML number forms only — python-only spellings (nan/inf/1_000) stay
            # strings, matching OmegaConf
            if re.fullmatch(r"[+-]?\d+", default):
                return int(default)
            if re.fullmatch(r"[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?", default):
                return float(default)
            return default
        try:
            return resolve_value(get_by_path(cfg, ref), depth + 1)
        except KeyError:
            raise ConfigError(f"interpolation ${{{ref}}} not found") from None

    return resolve_value(cfg)  # type: ignore[return-value]


def _check_mandatory(cfg: Dict[str, Any], prefix: str = "") -> None:
    for k, v in cfg.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            _check_mandatory(v, path + ".")
        elif v == "???":
            raise MissingMandatoryValue(f"mandatory config value {path} is not set")


def compose(
    overrides: Sequence[str] = (),
    config_name: str = "config",
    extra_dirs: Optional[Sequence[os.PathLike]] = None,
) -> dotdict:
    return Composer(extra_dirs).compose(overrides, config_name)


# targets outside the JAX package that the port replaces with its own
_FOREIGN_TARGETS = {"gymnasium.make": "sheeprl_tpu_torch.envs.classic.make"}


def repoint_targets(node: Any) -> Any:
    """``_target_``/``cls`` paths of the JAX package -> the port's modules (a
    config.yaml the JAX package wrote, read by the port)."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in ("_target_", "cls") and isinstance(v, str):
                if v.startswith("sheeprl_tpu."):
                    v = "sheeprl_tpu_torch." + v[len("sheeprl_tpu.") :]
                v = _FOREIGN_TARGETS.get(v, v)
            out[k] = repoint_targets(v)
        return out
    if isinstance(node, list):
        return [repoint_targets(v) for v in node]
    return node


def explicit_overrides(overrides: Sequence[str]) -> Dict[str, Any]:
    """The dotted key -> parsed value map of the explicit value overrides
    (``a.b=c`` and ``+a.b=c``; group selections and deletions excluded)."""
    _, dotted, additions, _ = Composer()._split_overrides(overrides)
    merged = dict(dotted)
    merged.update(additions)
    return merged
