"""Reading a reference checkpoint's training config (the part serving needs).

The port's copy of ``_resolve`` and ``agent_to_r3m_config`` from
``r3m_tpu/utils/config.py``: OmegaConf-style ``${key}`` / ``${now:fmt}`` interpolation
against the root config, and the mapping of an ``agent`` node onto `R3MConfig`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_EMBEDDED = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
_NOW = re.compile(r"\$\{now:([^}]+)\}")
_MISSING = object()  # sentinel: distinguish absent keys from null values


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
