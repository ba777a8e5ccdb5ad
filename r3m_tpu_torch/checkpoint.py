"""Checkpoints: native ``.npz`` snapshots and the reference's torch artifacts; the port of
``r3m_tpu/checkpoint.py``.

Native snapshots are the JAX package's format, so each package reads the other's files:
one ``.npz`` (a zip of raw arrays, no pickle) holding a flattened tree under encoded paths
(``d:`` dict key, ``l:`` list index, ``a:`` array, ``n:`` None, ``e:`` / ``E:`` an empty
dict / list) and a ``__meta__`` JSON entry (``global_step``, the model ``config``). A train
snapshot holds the JAX package's canonical train tree, ``{"params", "batch_stats",
"opt_state", "key"}``, with the port's own generator state beside it; `train_tree` builds
it from a port `TrainState` and `load_train_snapshot` reads it back (see there for the
optimizer and the generator). Layout: the rolling ``snapshot.npz`` and ``snapshot_{step}.npz``
of the reference (train_representation.py:123-138).

Reference artifacts (``model.pt`` / ``snapshot.pt``) load natively: the state dict keeps
the reference's names and layouts, and only the ``module.convnet.`` prefix comes off
(`r3m_tpu_torch.convert.convnet_state`); `import_torch_snapshot_to_state` and
`export_torch_snapshot` carry a train state in and out of that format.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from r3m_tpu_torch.convert import (
    canonical_path,
    canonical_tree,
    convnet_state,
    from_canonical,
    get_path,
    strip_prefix,
)

Tree = Any

_META_KEY = "__meta__"
_GENERATOR_KEY = "torch_generator"  # the port's generator state, beside the JAX tree


# ---------------------------------------------------------------------------------------
# Tree <-> flat dict with encoded paths ("d:a/l:0/d:w")


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:  # empty containers round-trip (a ViT's batch_stats={})
            out[prefix + "e:"] = np.zeros((0,))
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}d:{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[prefix + "E:"] = np.zeros((0,))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}l:{i}/"))
    elif tree is None:
        out[prefix + "n:"] = np.zeros((0,))
    else:
        out[prefix + "a:"] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        node[leaf] = None if leaf.startswith("n:") else arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if len(node) == 1:
            (k, v), = node.items()
            if k in ("a:", "n:"):
                return v
            if k == "e:":
                return {}
            if k == "E:":
                return []
        if all(k.startswith("l:") for k in node):
            return [build(v) for _, v in sorted(node.items(), key=lambda kv: int(kv[0][2:]))]
        return {k[2:]: build(v) for k, v in node.items()}

    return build(root)


def save_snapshot(path: str, tree: Tree, meta: Optional[Dict] = None) -> None:
    """Write a tree of host arrays and metadata to `path` (.npz), atomically (a temporary
    file, then a rename)."""
    flat = _flatten(tree)
    meta_arr = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat, **{_META_KEY: meta_arr})
    os.replace(tmp, path)


def load_snapshot(path: str) -> Tuple[Tree, Dict]:
    """Read a snapshot: ``(tree, meta)``, numpy leaves."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode("utf-8")) if _META_KEY in z.files else {}
    return _unflatten(flat), meta


# ---------------------------------------------------------------------------------------
# Train-state snapshots


def train_tree(state, cfg=None) -> Dict:
    """The canonical train tree of a port `TrainState`, as numpy copies on the host.

    ``params`` and ``batch_stats`` in the JAX package's names and layouts; ``opt_state``
    in optax's exact nesting, so that its loader pairs the leaves by position:
    ``[[count, mu, nu], []]`` for Adam (``[count]`` in place of ``[]`` when ``cfg.lr`` is a
    schedule string), ``[[[]], [[]], [], [trace]]`` for LARS, every moment in the layout of
    its parameter (a conv moment transposed as its kernel is); ``key``, the ``uint32[2]``
    JAX key ``[step, seed]`` of the port generator's seed (the JAX loader cannot use the
    generator); and the port generator's own state, which only the port reads.
    """
    from r3m_tpu_torch.training.trainer import Lars

    model, opt = state.model, state.optimizer
    named = list(model.named_parameters())

    def moments(key):  # zeros before the first update, as optax's init
        return canonical_tree((n, opt.state[p][key] if key in opt.state.get(p, ())
                               else torch.zeros_like(p)) for n, p in named)

    count = np.asarray(state.step, np.int32)
    if isinstance(opt, Lars):
        opt_state = [[[]], [[]], [], [moments("trace")]]
    else:  # the JAX optimizer takes a string lr as a schedule, with a count of its own
        schedule = cfg is not None and isinstance(cfg.lr, str)
        opt_state = [[count, moments("exp_avg"), moments("exp_avg_sq")],
                     [count] if schedule else []]
    seed = state.generator.initial_seed()
    return {
        "params": canonical_tree(named),
        "batch_stats": canonical_tree(model.named_buffers(), "batch_stats"),
        "opt_state": opt_state,
        "key": np.array([state.step, seed], np.uint64).astype(np.uint32),
        _GENERATOR_KEY: state.generator.get_state().numpy(),
    }


def _write_train_snapshot(work_dir: str, tree: Dict, meta: Dict, keep_step_copy: bool) -> str:
    rolling = os.path.join(work_dir, "snapshot.npz")
    if not keep_step_copy:
        save_snapshot(rolling, tree, meta)
        return rolling
    step_path = os.path.join(work_dir, f"snapshot_{meta['global_step']}.npz")
    save_snapshot(step_path, tree, meta)
    tmp = rolling + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    try:
        os.link(step_path, tmp)
    except OSError:  # cross-device or no-hardlink filesystem
        shutil.copyfile(step_path, tmp)
    os.replace(tmp, rolling)
    return rolling


def save_train_snapshot(work_dir: str, state, cfg=None, keep_step_copy: bool = True,
                        extra_meta: Optional[Dict] = None,
                        writer: Optional["AsyncSnapshotWriter"] = None) -> str:
    """Write `state` as ``snapshot_{step}.npz`` and the rolling ``snapshot.npz`` (a hard
    link to it, a copy where links fail), both with ``meta = {global_step, config,
    **extra_meta}``; only the rolling file with ``keep_step_copy=False``. Returns the
    rolling path. With a `writer`, the device -> host copy happens here and the
    serialisation and the write in the writer's thread; training may go on at once."""
    tree = train_tree(state, cfg)
    meta = {"global_step": int(state.step)}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    meta.update(extra_meta or {})
    if writer is None:
        return _write_train_snapshot(work_dir, tree, meta, keep_step_copy)
    writer.submit(lambda: _write_train_snapshot(work_dir, tree, meta, keep_step_copy))
    return os.path.join(work_dir, "snapshot.npz")


class AsyncSnapshotWriter:
    """Overlap snapshot serialisation and disk writes with training: at most one write in
    flight, and a failed write raises on the next `submit` or `wait`."""

    def __init__(self):
        self._thread = None
        self._err: Optional[BaseException] = None

    def submit(self, fn) -> None:
        """Run `fn()` (a write from host memory only) in the background."""
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async snapshot write failed") from err


def step_snapshots(work_dir: str):
    """``[(step, path)]`` of the ``snapshot_{step}.npz`` files in `work_dir`, newest first;
    other names (``snapshot_best.npz``) are ignored."""
    out = []
    for p in glob.glob(os.path.join(work_dir, "snapshot_*.npz")):
        m = re.fullmatch(r"snapshot_(\d+)\.npz", os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def r3m_config_from_meta(meta: Dict, **overrides):
    """The `R3MConfig` a snapshot's metadata names (fields it does not know are dropped).
    Levers that do not apply to the backbone (``remat`` on a ViT, ``vit_fused_attn`` on a
    ResNet), which older snapshots may carry, are reset with a warning."""
    from r3m_tpu_torch.models.r3m import R3MConfig

    cfg = {k: v for k, v in {**(meta.get("config") or {}), **overrides}.items()
           if k in R3MConfig.__dataclass_fields__}
    size = cfg.get("size", R3MConfig.size)
    for field, default, ok_values, bad in (
        ("remat", "none", ("none",), size == 0),
        ("vit_fused_attn", False, (False, "auto"), size != 0),
    ):
        if bad and cfg.get(field, default) not in ok_values:
            warnings.warn(f"snapshot config carries {field}={cfg[field]!r}, which does not "
                          f"apply to size={size}; ignoring it")
            cfg[field] = default
    return R3MConfig(**cfg)


def _load_named(named, tree: Dict, group: str) -> None:
    """Copy the tree's leaves into the named tensors, in place; a missing leaf or a shape
    that differs raises with the tensor's name."""
    with torch.no_grad():
        for name, x in named:
            where = canonical_path(name)
            if where is None or where[0] != group:
                continue
            try:
                value = from_canonical(get_path(tree, where[1]), where[2])
            except (KeyError, IndexError, TypeError) as e:
                raise ValueError(f"snapshot has no leaf for {name} ({where[1]})") from e
            if value.shape != x.shape:
                raise ValueError(
                    f"snapshot/state shape mismatch at {name}: {tuple(value.shape)} vs "
                    f"{tuple(x.shape)} — the snapshot was saved from a different "
                    "architecture/config than the restoring state")
            x.copy_(value)


def load_train_snapshot(path: str, state, with_meta: bool = False):
    """Load a train snapshot, the port's or the JAX package's, into `state` in place
    (parameters, BatchNorm statistics, optimizer moments, step, generator) and return it
    (``(state, meta)`` with `with_meta`).

    Adam's ``(count, mu, nu)`` become each parameter's ``(step, exp_avg, exp_avg_sq)``,
    LARS's trace its ``trace``. A port snapshot restores the generator's state, so a
    resume continues the same draws; a JAX snapshot has only a JAX key, which no
    `torch.Generator` can follow: the generator is then reseeded with the key's 64 bits,
    deterministically.
    """
    from r3m_tpu_torch.training.trainer import Lars

    tree, meta = load_snapshot(path)
    model, opt = state.model, state.optimizer
    named = list(model.named_parameters())
    _load_named(named, tree["params"], "params")
    _load_named(model.named_buffers(), tree["batch_stats"], "batch_stats")
    opt.state.clear()
    if isinstance(opt, Lars):
        keys, trees, count = ("trace",), (tree["opt_state"][3][0],), None
    else:
        adam = tree["opt_state"][0]
        keys, trees, count = ("exp_avg", "exp_avg_sq"), (adam[1], adam[2]), int(adam[0])
    for key, moment in zip(keys, trees):
        moments = [(n, torch.empty_like(p)) for n, p in named]
        _load_named(moments, moment, "params")
        for (_, p), (_, m) in zip(named, moments):
            opt.state[p][key] = m
    if count is not None:
        for _, p in named:
            opt.state[p]["step"] = torch.tensor(float(count))
    state.step = int(meta.get("global_step", 0))
    generator = tree.get(_GENERATOR_KEY)
    if generator is not None and generator.size == state.generator.get_state().numel():
        state.generator.set_state(torch.from_numpy(np.ascontiguousarray(generator)))
    else:
        key = np.asarray(tree["key"], np.uint64)
        state.generator.manual_seed(int(key[0]) << 32 | int(key[1]))
    return (state, meta) if with_meta else state


# ---------------------------------------------------------------------------------------
# Reference (torch) artifacts


def load_torch_payload(path: str):
    """Guarded ``torch.load`` of a reference artifact; returns the raw payload."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        # Retry the unsafe path ONLY for weights_only rejections (payloads with
        # non-tensor globals, e.g. OmegaConf nodes in old snapshots); a corrupt file
        # raises UnpicklingError too, but without the weights_only wording, and must
        # surface its real error.
        msg = str(e)
        if "weights_only" not in msg and "Weights only" not in msg:
            raise
        return torch.load(path, map_location="cpu", weights_only=False)


def torch_payload_state_dict(payload) -> Dict:
    """The model state dict of a reference payload (``{"r3m": sd, "global_step": ...}``
    for snapshots, a bare state dict for model.pt — train_representation.py:123-138)."""
    if isinstance(payload, dict) and "r3m" in payload:
        return payload["r3m"]
    return payload


def load_convnet(path: str) -> Tuple[Dict[str, Any], int, Optional[int]]:
    """``(backbone state dict, size, image size or None)`` of a reference artifact."""
    return convnet_state(torch_payload_state_dict(load_torch_payload(path)))


def import_torch_snapshot_to_state(path: str, state):
    """Seed a port `TrainState` from a reference torch snapshot (``{"r3m": state_dict,
    "global_step"}``): the backbone's parameters and BatchNorm statistics, and the reward
    head when the state has one; the step from ``global_step``. The optimizer restarts
    fresh, as in the JAX package."""
    payload = load_torch_payload(path)
    sd = strip_prefix(dict(torch_payload_state_dict(payload)))
    model = state.model
    if model.lang_rew is not None and not any(k.startswith("lang_rew.") for k in sd):
        raise ValueError("state expects lang_rew but torch snapshot has none")
    parts = {"convnet": model.convnet, "lang_rew": model.lang_rew}
    for prefix, module in parts.items():
        if module is not None:
            module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()
                                    if k.startswith(prefix + ".")})
    state.optimizer.state.clear()
    if isinstance(payload, dict) and "global_step" in payload:
        state.step = int(payload["global_step"])
    else:
        state.step = 0
    return state


def export_torch_snapshot(path: str, state, data_parallel: bool = True) -> str:
    """Write a port `TrainState` as a reference-format torch snapshot: the pickled
    ``{"r3m": state_dict, "global_step": int}`` of train_representation.py:123-130, keys
    ``module.convnet.*`` / ``module.lang_rew.*``, so the reference's `load_snapshot` /
    `load_r3m` and the JAX package's `import_torch_snapshot_to_state` read it."""
    pre = "module." if data_parallel else ""
    payload = {
        "r3m": {pre + k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
        "global_step": int(state.step),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path
