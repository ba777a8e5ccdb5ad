"""The training config: YAML, Hydra-style overrides and ``${...}`` interpolation.

The port's copy of ``r3m_tpu/utils/config.py``: `load_config` reads a root YAML (the
repo's ``cfgs/config_rep.yaml``), applies strict ``key.path=value`` overrides (an unknown
key raises, ``+key=value`` adds one), then resolves OmegaConf-style ``${key}`` /
``${now:fmt}`` interpolation against the root; `agent_to_r3m_config` maps the ``agent``
node onto `R3MConfig`. The ``agent`` node's ``_target_`` names the JAX package's class;
`agent_to_r3m_config` reads it as data and imports nothing it names. `instantiate` is
the Hydra-style ``_target_`` import-and-call, for nodes that name what the caller wants
built.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import re
from typing import Any, Dict, List, Optional

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_EMBEDDED = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
_NOW = re.compile(r"\$\{now:([^}]+)\}")
_MISSING = object()  # sentinel: distinguish absent keys from null values


class Config(dict):
    """A dict with attribute access and nested dot-path get/set."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            # cache the converted child, so that attribute writes to nested nodes
            # (cfg.agent.langweight = 1.0) change this config, not a throwaway copy
            v = Config(v)
            self[k] = v
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path: str, default=None):
        node = _get_path(self, path)
        return default if node is _MISSING else node

    def set_path(self, path: str, value) -> None:
        parts = path.split(".")
        node: Dict = self
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def has_path(self, path: str) -> bool:
        return _get_path(self, path) is not _MISSING


def _parse_value(text: str) -> Any:
    """A YAML-typed scalar ('1e-4' stays a string as YAML 1.1 has it, 'true' -> bool)."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_config(
    path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    base: Optional[Dict] = None,
) -> Config:
    """Load YAML over `base`, apply ``key.path=value`` overrides, resolve ``${...}``.

    Overrides are strict for a config read from a file or a base: a key that is not
    there raises `KeyError` (a typo such as ``batch_sise=4``); ``+key=value`` adds one.
    """
    import yaml

    cfg: Dict = copy.deepcopy(base) if base else {}
    if path is not None:
        with open(path) as f:
            cfg.update(yaml.safe_load(f) or {})
    c = Config(cfg)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        key, val = ov.split("=", 1)
        key = key.strip()
        if key.startswith("+"):
            key = key[1:]
        elif (path is not None or base) and not c.has_path(key):
            raise KeyError(f"unknown config key {key!r} (use +{key}=... to add a new key)")
        c.set_path(key, _parse_value(val))
    return Config(_resolve(dict(c), dict(c)))


def _get_path(root: Dict, path: str):
    node: Any = root
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return _MISSING
        node = node[part]
    return node


def _resolve(node: Any, root: Dict, _stack: tuple = (), _now=None) -> Any:
    if _now is None:
        # one timestamp per top-level resolve: every ${now:} names the SAME instant
        import time

        _now = time.localtime()
    if isinstance(node, dict):
        return {k: _resolve(v, root, _stack, _now) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root, _stack, _now) for v in node]
    if isinstance(node, str):
        def lookup(key: str, expr: str):
            if key in _stack:
                raise ValueError("interpolation cycle: " + " -> ".join((*_stack, key)))
            ref = _get_path(root, key)
            if ref is _MISSING:
                raise KeyError(f"unresolvable interpolation: {expr}")
            # null-valued keys (n_devices: ~) resolve to None, as OmegaConf
            return _resolve(ref, root, _stack + (key,), _now)

        if _NOW.search(node):
            import time

            node = _NOW.sub(lambda mm: time.strftime(mm.group(1), _now), node)

        m = _INTERP.match(node)
        if m:  # whole-string interpolation keeps the referent's TYPE
            return lookup(m.group(1), node)
        if _INTERP_EMBEDDED.search(node):
            # embedded form ('${root}/data') substitutes as text
            return _INTERP_EMBEDDED.sub(
                lambda mm: str(lookup(mm.group(1), mm.group(0))), node
            )
    return node


def _check_schedule(text: str) -> None:
    """Raise ValueError unless `text` is one of the reference's lr schedule strings,
    'linear(init,final,duration)' or 'step_linear(init,final1,duration1,final2,duration2)'."""
    m = re.fullmatch(r"(step_linear|linear)\((.+)\)", text)
    args = m.group(2).split(",") if m else []
    if len(args) != (5 if m and m.group(1) == "step_linear" else 3):
        raise ValueError(f"not a number or an lr schedule: {text!r}")
    for a in args:
        float(a)


def instantiate(node: Dict, **extra) -> Any:
    """Import the callable that ``node["_target_"]`` names (``"package.module.attr"``) and
    call it with the node's other keys, `extra` over them (r3m/__init__.py:71)."""
    node = dict(node)
    mod_name, _, attr = node.pop("_target_").rpartition(".")
    node.update(extra)
    return getattr(importlib.import_module(mod_name), attr)(**node)


def agent_to_r3m_config(agent: Dict):
    """Map a reference-style `agent` config node onto `R3MConfig`.

    Accepts the reference field set (r3m/cfgs/config_rep.yaml:30-41), ignoring keys
    `R3MConfig` does not have (`device`, `_target_`).
    """
    from r3m_tpu_torch.models.r3m import R3MConfig

    fields = {f.name: f for f in dataclasses.fields(R3MConfig)}
    kwargs = {}
    for k, v in agent.items():
        if k not in fields:
            continue
        # pyyaml parses exponent-only literals like `1e-5` as strings (YAML 1.1
        # requires a dot); coerce to the dataclass field type.
        ftype = fields[k].type
        if isinstance(v, str) and ftype in ("float", float):
            try:
                v = float(v)
            except ValueError:
                if k != "lr":
                    raise
                _check_schedule(v)  # lr also takes the reference's schedule strings
        elif isinstance(v, str) and ftype in ("int", int):
            v = int(float(v))
        kwargs[k] = v
    return R3MConfig(**kwargs)
