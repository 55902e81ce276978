"""Hydra-style configuration: composition, interpolation, overrides and
`_target_` instantiation (counterpart of oneprot_tpu/core/config.py).

    cfg = load_config(default_config_dir(), "train",
                      ["experiment=debug_struct_token", "trainer=cpu"])
    cfg = prepare_run_dir(cfg)          # resolves ${...}, writes the snapshot
    trainer = instantiate(cfg.trainer)  # oneprot_tpu_torch.train.trainer.Trainer

It composes the same trees as the JAX package from the same `configs/`:
defaults lists with `_self_`, `optional` and `override /group` entries,
`# @package` directives, `${a.b}`, `${..x}`, `${oc.env:VAR[,default]}`,
`${hydra:...}` and `${now:...}` interpolation, and CLI overrides
(`a.b=v`, `+a.b=v`, `~a.b`, `group=option`). Files and override values are
read by `yaml_io` (the same YAML 1.1 scalars as PyYAML's safe_load).

The committed configs name the JAX package's targets. `_locate` applies
`TARGET_ALIASES` first, then rewrites the `oneprot_tpu.` prefix to
`oneprot_tpu_torch.` before any import, so the JAX package is never
imported; every committed target has its counterpart in the port.
Under a torch.distributed process group every rank takes rank 0's run
stamp (one run dir) and rank 0 alone writes the snapshot.
"""

from __future__ import annotations

import copy
import datetime
import importlib
import json
import os
import re
from functools import partial
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from oneprot_tpu_torch.core import yaml_io

# ---------------------------------------------------------------------------
# ConfigNode: dict with attribute access (DictConfig-alike)


class ConfigNode(dict):
    """A dict that also supports attribute access, like omegaconf.DictConfig."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key: str, default: Any = None) -> Any:
        return dict.get(self, key, default)

    def copy(self) -> "ConfigNode":
        return to_config(copy.deepcopy(dict(self)))


def to_config(obj: Any) -> Any:
    """Recursively convert dicts to ConfigNode."""
    if isinstance(obj, dict):
        return ConfigNode({k: to_config(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [to_config(v) for v in obj]
    return obj


def to_plain(obj: Any) -> Any:
    """Recursively convert ConfigNode back to plain dict/list."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def merge(base: Any, override: Any) -> Any:
    """Deep merge: override wins; dicts merge recursively, others replace."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = ConfigNode(base)
        for k, v in override.items():
            if k in out:
                out[k] = merge(out[k], v)
            else:
                out[k] = to_config(v)
        return out
    return to_config(copy.deepcopy(override))


# ---------------------------------------------------------------------------
# Interpolation

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class InterpolationError(KeyError):
    pass


class _Resolver:
    """Resolves ``${...}`` interpolations against a root config tree."""

    def __init__(self, root: Any, resolvers: Optional[Dict[str, Any]] = None):
        self.root = root
        self.resolvers = resolvers or {}
        self._resolving: set = set()

    def _lookup(self, expr: str, parent_path: Tuple[str, ...]) -> Any:
        expr = expr.strip()
        if ":" in expr:  # a resolver: name:args
            name, _, arg = expr.partition(":")
            if name in self.resolvers:
                return self.resolvers[name](arg)
            if name == "now":
                return datetime.datetime.now().strftime(
                    arg.strip() or "%Y-%m-%d_%H-%M-%S")
            if name == "oc.env":
                parts = arg.split(",", 1)
                var = parts[0].strip()
                if var in os.environ:
                    return os.environ[var]
                if len(parts) > 1:
                    return parts[1].strip()
                raise InterpolationError(f"Environment variable '{var}' not set")
            raise InterpolationError(f"Unknown resolver '{name}' in ${{{expr}}}")
        # leading dots: one = the node holding the value, two = its parent
        n_dots = len(expr) - len(expr.lstrip("."))
        rel = expr[n_dots:]
        base_path = (parent_path[: len(parent_path) - (n_dots - 1)]
                     if n_dots > 0 else ())
        keys = [k for k in rel.split(".") if k] if rel else []
        node = self.root
        for k in base_path:
            node = node[k]
        for k in keys:
            if isinstance(node, list):
                node = node[int(k)]
            elif isinstance(node, dict) and k in node:
                node = node[k]
            else:
                raise InterpolationError(
                    f"Interpolation key '{expr}' not found (missing '{k}')")
        full_path = tuple(base_path) + tuple(keys)
        if isinstance(node, (dict, list)):
            return self.resolve_tree(node, full_path)
        return self.resolve_value(node, full_path[:-1] if full_path else ())

    def resolve_value(self, value: Any, parent_path: Tuple[str, ...]) -> Any:
        if not isinstance(value, str):
            return value
        key = (parent_path, value)
        if key in self._resolving:
            raise InterpolationError(f"Circular interpolation at {value!r}")
        m = _INTERP_RE.fullmatch(value.strip())
        self._resolving.add(key)
        try:
            if m:  # the whole string: keep the referenced value's type
                return self._lookup(m.group(1), parent_path)
            if "${" in value:
                return _INTERP_RE.sub(
                    lambda match: str(self._lookup(match.group(1), parent_path)),
                    value)
            return value
        finally:
            self._resolving.discard(key)

    def resolve_tree(self, node: Any, path: Tuple[str, ...] = ()) -> Any:
        """`path` is the path of `node`; leaf values resolve against their
        containing node (OmegaConf's relative interpolation)."""
        if isinstance(node, dict):
            out = ConfigNode()
            for k, v in node.items():
                out[k] = (self.resolve_tree(v, path + (k,))
                          if isinstance(v, (dict, list))
                          else self.resolve_value(v, path))
            return out
        if isinstance(node, list):
            return [self.resolve_tree(v, path) if isinstance(v, (dict, list))
                    else self.resolve_value(v, path) for v in node]
        return self.resolve_value(node, path)


def resolve(cfg: Any, resolvers: Optional[Dict[str, Any]] = None) -> Any:
    """Resolve all interpolations eagerly, returning a new tree."""
    return _Resolver(cfg, resolvers).resolve_tree(cfg)


# ---------------------------------------------------------------------------
# Composition (defaults lists)

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)")


def _load_yaml(path: Path) -> Tuple[Any, Optional[str]]:
    text = path.read_text()
    package = None
    for line in text.splitlines()[:5]:
        m = _PACKAGE_RE.match(line.strip())
        if m:
            package = m.group(1)
            break
    data = yaml_io.load(text, source=str(path))
    return to_config(data if data is not None else {}), package


def _place_at_package(cfg: Any, package: Optional[str], default_package: str) -> Any:
    """Wrap cfg into the key path given by its package directive."""
    pkg = package if package is not None else default_package
    if pkg in ("_global_", ""):
        return cfg
    out = cfg
    for key in reversed(pkg.split(".")):
        out = ConfigNode({key: out})
    return out


class ConfigStore:
    """Loads and composes config groups from a config directory tree."""

    def __init__(self, config_dir: Union[str, Path]):
        self.config_dir = Path(config_dir)
        if not self.config_dir.is_dir():
            raise FileNotFoundError(f"Config dir not found: {self.config_dir}")

    def _find(self, group: str, name: str) -> Path:
        name = name if name.endswith(".yaml") else name + ".yaml"
        path = self.config_dir / group / name if group else self.config_dir / name
        if not path.is_file():
            raise FileNotFoundError(f"Config not found: {path}")
        return path

    def compose(self, config_name: str,
                overrides: Optional[List[str]] = None) -> ConfigNode:
        overrides = list(overrides or [])
        # group choices (`trainer=cpu`) apart from value overrides
        group_choices: Dict[str, Optional[str]] = {}
        value_overrides: List[str] = []
        for ov in overrides:
            if ov.startswith("~"):
                value_overrides.append(ov)
                continue
            key, _, val = ov.partition("=")
            plus = key.startswith("+")
            raw_key = key.lstrip("+")
            if (not plus and "=" in ov and "." not in raw_key
                    and self._group_exists(raw_key)
                    and not _looks_like_literal(val)):
                group_choices[raw_key] = None if val in ("null", "None") else val
            elif plus and self._group_exists(raw_key) and not _looks_like_literal(val):
                group_choices[raw_key] = val
            else:
                value_overrides.append(ov)

        # `override /group: option` entries of the chosen files replace the
        # root's choice for that group; the command line's choices win
        derived: Dict[str, Optional[str]] = {}
        for grp, opt in list(group_choices.items()):
            if opt is not None:
                self._scan_choice_overrides(grp, opt, derived)
        for grp, opt in derived.items():
            group_choices.setdefault(grp, opt)

        cfg = self._compose_file("", config_name, group_choices, is_root=True)
        for ov in value_overrides:
            cfg = apply_override(cfg, ov)
        return cfg

    def _scan_choice_overrides(self, group: str, name: str,
                               acc: Dict[str, Optional[str]]) -> None:
        if "/" in name:
            sub_dir, name = name.rsplit("/", 1)
            group = f"{group}/{sub_dir}" if group else sub_dir
        try:
            raw, _ = _load_yaml(self._find(group, name))
        except FileNotFoundError:
            return
        defaults = raw.get("defaults") if isinstance(raw, dict) else None
        for entry in defaults or []:
            if isinstance(entry, str):
                if entry != "_self_":
                    self._scan_choice_overrides(group, entry, acc)
                continue
            (entry_key, option), = entry.items()
            if not isinstance(entry_key, str):
                continue
            if entry_key.startswith("override "):
                target = entry_key[len("override "):].lstrip("/")
                if option is not None:
                    acc.setdefault(target, str(option))
                    self._scan_choice_overrides(target, str(option), acc)

    def _group_exists(self, key: str) -> bool:
        return (self.config_dir / key).is_dir()

    def _compose_file(self, group: str, name: str,
                      group_choices: Dict[str, Optional[str]],
                      is_root: bool = False) -> ConfigNode:
        # "modalities/pocket" lives in <group>/modalities and packages at
        # data.modalities (hydra's default package)
        if "/" in name:
            sub_dir, name = name.rsplit("/", 1)
            group = f"{group}/{sub_dir}" if group else sub_dir
        path = self._find(group, name)
        raw, package = _load_yaml(path)
        defaults = raw.pop("defaults", None) if isinstance(raw, dict) else None
        self_cfg = _place_at_package(raw, package,
                                     default_package=group.replace("/", "."))
        if defaults is None:
            return self_cfg

        composed: ConfigNode = ConfigNode()
        self_done = False
        for entry in defaults:
            if entry == "_self_":
                composed = merge(composed, self_cfg)
                self_done = True
                continue
            if isinstance(entry, str):
                # a bare include within the same group ("model_checkpoint.yaml")
                composed = merge(composed, self._compose_file(group, entry,
                                                              group_choices))
                continue
            (entry_key, option), = entry.items()
            optional = False
            if isinstance(entry_key, str) and entry_key.startswith("optional "):
                optional = True
                entry_key = entry_key[len("optional "):]
            if isinstance(entry_key, str) and entry_key.startswith("override "):
                if not is_root:
                    # the compose() pre-scan turned it into the root's choice
                    continue
                entry_key = entry_key[len("override "):]
            if entry_key.startswith("/"):
                sub_group = entry_key[1:]
            elif group and "/" not in entry_key and not is_root:
                sub_group = f"{group}/{entry_key}"
            else:
                sub_group = entry_key
            if option is not None and "/" in str(option):
                # "modalities/msa": the option carries its path
                opt_path, opt_name = str(option).rsplit("/", 1)
                sub_group = f"{group}/{opt_path}" if group else opt_path
                option = opt_name
                choice_key = entry_key
            else:
                choice_key = sub_group if is_root else entry_key
            if choice_key in group_choices:
                option = group_choices[choice_key]
            elif sub_group in group_choices:
                option = group_choices[sub_group]
            if option is None:
                continue
            explicit = choice_key in group_choices or sub_group in group_choices
            try:
                sub = self._compose_file(sub_group, str(option), group_choices)
            except FileNotFoundError:
                if optional and not explicit:
                    continue
                if explicit:
                    group_dir = self.config_dir / sub_group
                    available = (sorted(p.stem for p in group_dir.glob("*.yaml"))
                                 if group_dir.is_dir() else [])
                    raise FileNotFoundError(
                        f"Config '{option}' not found in group '{sub_group}'. "
                        f"Available: {available}")
                # the group may sit at the root
                sub = self._compose_file(entry_key, str(option), group_choices)
            composed = merge(composed, sub)
        if not self_done:
            composed = merge(composed, self_cfg)
        return composed


def _looks_like_literal(val: str) -> bool:
    """True when an override's value reads as a number, bool, null,
    collection or malformed YAML: then `key=val` sets a value, not a group
    choice."""
    if val == "":
        return True
    try:
        v = yaml_io.load(val, source="override value")
    except yaml_io.YamlError:
        return True
    return isinstance(v, (int, float, bool, list, dict)) or v is None


def apply_override(cfg: ConfigNode, override: str) -> ConfigNode:
    """Apply one CLI override: 'a.b=v', '+a.b=v' (add), '~a.b' (delete)."""
    if override.startswith("~"):
        keys = override[1:].split("=")[0].split(".")
        node = cfg
        for k in keys[:-1]:
            node = node[k]
        node.pop(keys[-1], None)
        return cfg
    key, _, val = override.partition("=")
    additive = key.startswith("+")
    key = key.lstrip("+")
    keys = key.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if additive:
                node[k] = ConfigNode()
            else:
                raise KeyError(
                    f"Override key '{key}' not found (use +{key}=... to add)")
        node = node[k]
    if not additive and keys[-1] not in node:
        raise KeyError(f"Override key '{key}' not found (use +{key}=... to add)")
    value = (yaml_io.load(val, source=f"override {override!r}") if val != ""
             else None)
    node[keys[-1]] = to_config(value)
    return cfg


# ---------------------------------------------------------------------------
# Instantiation (_target_)

# reference-style or test targets -> importable ones (applied before the
# prefix rewrite); the reference's encoder targets name the port's factories
TARGET_ALIASES: Dict[str, str] = {
    f"src.models.components.{reference}":
        f"oneprot_tpu_torch.models.encoders.{factory}"
    for reference, factory in (
        ("sequence_encoder.SequenceEncoder", "create_sequence_encoder"),
        ("struct_token_encoder.StructTokenEncoder",
         "create_struct_token_encoder"),
        ("text_encoder.TextEncoder", "create_text_encoder"),
        ("struct_graph_encoder.StructEncoder", "create_struct_graph_encoder"),
        ("msa_encoder.MsaEncoder", "create_msa_encoder"))}
_JAX_PREFIX, _PORT_PREFIX = "oneprot_tpu.", "oneprot_tpu_torch."


def register_target_alias(reference_target: str, native_target: str) -> None:
    TARGET_ALIASES[reference_target] = native_target


def port_target(target: str) -> str:
    """The alias of `target`, with the JAX package's prefix rewritten to the
    port's."""
    target = TARGET_ALIASES.get(target, target)
    if target.startswith(_JAX_PREFIX):
        target = _PORT_PREFIX + target[len(_JAX_PREFIX):]
    return target


def _locate(target: str) -> Any:
    target = port_target(target)
    module_name = target.rpartition(".")[0]
    last_err: Optional[Exception] = None
    while module_name:
        try:
            obj = importlib.import_module(module_name)
            for part in target[len(module_name) + 1:].split("."):
                obj = getattr(obj, part)
            return obj
        except (ImportError, AttributeError) as e:
            last_err = e
            module_name, _, _ = module_name.rpartition(".")
    raise ImportError(f"Cannot locate target '{target}': {last_err}")


def instantiate(cfg: Any, *args: Any, **kwargs: Any) -> Any:
    """Hydra-style instantiation: dicts with _target_ become objects, with
    `_partial_` (a functools.partial), `_recursive_` (nested _target_ dicts,
    on by default) and `_convert_` (ignored); `kwargs` override the
    config's keys."""
    if isinstance(cfg, (list, tuple)):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return ConfigNode({k: instantiate(v) for k, v in cfg.items()})
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    is_partial = bool(cfg.pop("_partial_", False))
    recursive = bool(cfg.pop("_recursive_", True))
    cfg.pop("_convert_", None)
    obj = _locate(target)
    if recursive:
        call_kwargs = {k: instantiate(v) for k, v in cfg.items()}
    else:
        call_kwargs = {k: to_plain(v) for k, v in cfg.items()}
    call_kwargs.update(kwargs)
    if is_partial:
        return partial(obj, *args, **call_kwargs)
    return obj(*args, **call_kwargs)


# ---------------------------------------------------------------------------
# Run dir and config snapshot


def prepare_run_dir(cfg: ConfigNode, output_dir: Optional[str] = None) -> ConfigNode:
    """Resolve the config with a concrete output dir and snapshot it to disk."""
    if output_dir is None:
        stamp = _sync_stamp(
            datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
        # paths.* first, so that the run dir's interpolations are concrete
        pre = _Resolver(cfg, resolvers={"hydra": lambda a: "",
                                        "now": lambda a: stamp})
        run_dir_tmpl = ((cfg.get("hydra") or {}).get("run") or {}).get("dir")
        if run_dir_tmpl:
            try:
                output_dir = str(pre.resolve_value(
                    str(run_dir_tmpl).replace("${now}", stamp),
                    ("hydra", "run")))
            except InterpolationError:
                output_dir = None
        if output_dir is None:
            try:
                root = pre.resolve_tree(cfg.get("paths", {}), ("paths",)).get(
                    "log_dir", "logs")
            except InterpolationError:
                root = "logs"
            task = cfg.get("task_name", "run")
            output_dir = os.path.join(str(root), str(task), "runs", stamp)
    # pin the concrete run dir, so that the template's ${now} never reaches
    # the final resolve
    if isinstance(cfg.get("hydra"), dict):
        cfg = merge(cfg, {"hydra": {"run": {"dir": output_dir}}})
    resolvers = {
        "hydra": lambda arg: {
            "runtime.output_dir": output_dir,
            "runtime.cwd": os.getcwd(),
        }.get(arg.strip(), ""),
    }
    resolved = resolve(cfg, resolvers=resolvers)
    os.makedirs(output_dir, exist_ok=True)
    snapshot_config(resolved, output_dir)
    return resolved


def _sync_stamp(stamp: str) -> str:
    """The run stamp, rank 0's on every rank of a process group (clocks
    that straddle a second would split one run over two directories).
    Call `core.mesh.init_distributed` first: the CLIs do."""
    from oneprot_tpu_torch.core.collectives import broadcast_str

    return broadcast_str(stamp)


def snapshot_config(cfg: ConfigNode, output_dir: str) -> None:
    """Write the resolved config as resolved_config.yaml and .json, on
    rank 0 only (every rank holds the same config)."""
    from oneprot_tpu_torch.core.mesh import is_main_process

    if not is_main_process():
        return
    plain = to_plain(cfg)
    with open(os.path.join(output_dir, "resolved_config.yaml"), "w") as f:
        f.write(yaml_io.dump(plain))
    with open(os.path.join(output_dir, "resolved_config.json"), "w") as f:
        json.dump(plain, f, indent=2, default=str)


def load_config(config_dir: Union[str, Path], config_name: str,
                overrides: Optional[List[str]] = None) -> ConfigNode:
    """One-shot compose, mirroring hydra.compose."""
    return ConfigStore(config_dir).compose(config_name, overrides)
