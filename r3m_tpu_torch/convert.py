"""Weight carry between the JAX package's pytrees and the port's torch state dicts.

The port keeps the reference's torch names and layouts, so a reference ``model.pt`` loads
natively. `state_dict_from_jax` turns a JAX numpy pytree (``{"convnet": ...}`` params and
batch stats) into that format: HWIO -> OIHW convolutions, BN scale/bias/mean/var ->
weight/bias/running_mean/running_var, dense ``[in, out]`` -> Linear ``[out, in]``, and the
HF ``ViTModel`` names for size 0. `model_from_jax` carries a JAX train state's params and
batch stats into an `R3MModel`, and `distilbert_state_from_jax` the frozen DistilBERT
pytree into HF ``DistilBertModel`` names (the inverse of the JAX ``convert_distilbert``);
`policy_params_from_jax` carries a JAX BC-probe policy.
The other way, `canonical_path` names where each `R3MModel` tensor lives in the JAX
package's canonical tree (unpacked BatchNorm, as its snapshots hold it) and how its layout
changes, and `canonical_tree` builds that tree from named tensors: the port's copy of the
JAX ``convert_resnet`` / ``convert_linear`` / ``convert_language_reward`` and ``convert_vit``.
`convert_language_stack` takes a reference state dict's reward head and embedded DistilBERT,
and `distilbert_tree` writes an HF DistilBERT as the JAX package's pytree. The numpy input
is all it reads: it imports nothing of JAX. `main` is the conversion CLI::

    python -m r3m_tpu_torch.convert to-native snapshot.pt out.npz
    python -m r3m_tpu_torch.convert to-torch  snapshot.npz out.pt
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from r3m_tpu_torch.models.distilbert import (
    DistilBert,
    _normalize_hf_state,
    bert_from_state,
    config_from_params,
    distilbert_config_from_state,
)
from r3m_tpu_torch.models import dinov2
from r3m_tpu_torch.models.r3m import R3MConfig, R3MModel
from r3m_tpu_torch.models.resnet import RESNET_SPECS
from r3m_tpu_torch.models.vit import require_b32_geometry, vit_config_from_state

StateDict = Mapping[str, Any]


def strip_prefix(sd: StateDict, prefix: str = "module.") -> Dict[str, Any]:
    """Remove a key prefix (DataParallel adds ``module.``)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def detect_resnet_size(sd: StateDict, prefix: str = "") -> int:
    """Infer 18/34/50 from state-dict structure."""
    keys = set(sd.keys())
    if f"{prefix}layer1.0.conv3.weight" in keys:
        return 50
    # basic blocks: count blocks in layer3 — resnet18 has 2, resnet34 has 6
    pattern = re.escape(prefix) + r"layer3\.(\d+)\."
    n = len({m.group(1) for k in keys for m in [re.match(pattern, k)] if m})
    return 34 if n == 6 else 18


def convnet_state(sd: StateDict) -> Tuple[Dict[str, Any], Any, Optional[int]]:
    """The backbone of a reference R3M state dict: ``(state dict, size, image size)``.

    Strips ``module.`` and ``convnet.``; the rest (a language head) is left out. `size`
    is 0 for an HF ViT, whose crop size comes from its position table; for a ResNet the
    image size is None. An HF ``Dinov2WithRegistersModel`` state dict, under
    ``convnet.`` or as HF saves it, gives `size` ``"dinov2_vitg14_reg"`` and no image
    size (its position table is resized to any grid).
    """
    sd = strip_prefix(dict(sd))
    enc = {k[len("convnet."):]: v for k, v in sd.items() if k.startswith("convnet.")}
    if not enc and "embeddings.register_tokens" in sd:
        enc = sd
    if "embeddings.register_tokens" in enc:
        dinov2.dinov2_config_from_state(enc)  # raises for what is not DINOv2's layout
        return enc, dinov2.NAME, None
    if "embeddings.cls_token" in enc:
        vcfg = vit_config_from_state(enc)
        require_b32_geometry(vcfg)
        return enc, 0, vcfg.image_size
    return enc, detect_resnet_size(enc), None


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_w(w) -> torch.Tensor:
    """HWIO -> OIHW."""
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))
    )


def _linear(sd: Dict[str, torch.Tensor], key: str, p: Mapping) -> None:
    """{"w": [in, out], "b": [out]} -> nn.Linear entries."""
    sd[f"{key}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32)))
    )
    if "b" in p:
        sd[f"{key}.bias"] = _t(p["b"])


def _bn(sd: Dict[str, torch.Tensor], key: str, p: Mapping, s: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def resnet_state(params: Mapping, batch_stats: Mapping, size: int, prefix: str = ""):
    """JAX ResNet (params, batch_stats) -> torchvision state dict."""
    spec = RESNET_SPECS[size]
    sd: Dict[str, torch.Tensor] = {f"{prefix}conv1.weight": _conv_w(params["conv1"]["w"])}
    _bn(sd, f"{prefix}bn1", params["bn1"], batch_stats["bn1"])
    n_convs = 2 if spec.block == "basic" else 3
    for stage, num_blocks in enumerate(spec.stage_sizes):
        layer = f"layer{stage + 1}"
        for b in range(num_blocks):
            bp, bs = params[layer][b], batch_stats[layer][b]
            base = f"{prefix}{layer}.{b}"
            for ci in range(1, n_convs + 1):
                sd[f"{base}.conv{ci}.weight"] = _conv_w(bp[f"conv{ci}"]["w"])
                _bn(sd, f"{base}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "downsample" in bp:
                sd[f"{base}.downsample.0.weight"] = _conv_w(bp["downsample"]["conv"]["w"])
                _bn(sd, f"{base}.downsample.1", bp["downsample"]["bn"],
                    bs["downsample"]["bn"])
    return sd


def vit_state(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ViT pytree -> HF ViTModel state dict (the inverse of the JAX ``convert_vit``)."""
    sd: Dict[str, torch.Tensor] = {}

    def ln(key, p):
        sd[f"{prefix}{key}.weight"] = _t(p["scale"])
        sd[f"{prefix}{key}.bias"] = _t(p["bias"])

    sd[f"{prefix}embeddings.patch_embeddings.projection.weight"] = _conv_w(params["patch"]["w"])
    sd[f"{prefix}embeddings.patch_embeddings.projection.bias"] = _t(params["patch"]["b"])
    sd[f"{prefix}embeddings.cls_token"] = _t(params["cls"])
    sd[f"{prefix}embeddings.position_embeddings"] = _t(params["pos"])
    ln("layernorm", params["final_ln"])
    _linear(sd, f"{prefix}pooler.dense", params["pooler"])
    for i, layer in enumerate(params["layers"]):
        base = f"encoder.layer.{i}"
        ln(f"{base}.layernorm_before", layer["ln1"])
        _linear(sd, f"{prefix}{base}.attention.attention.query", layer["q"])
        _linear(sd, f"{prefix}{base}.attention.attention.key", layer["k"])
        _linear(sd, f"{prefix}{base}.attention.attention.value", layer["v"])
        _linear(sd, f"{prefix}{base}.attention.output.dense", layer["o"])
        ln(f"{base}.layernorm_after", layer["ln2"])
        _linear(sd, f"{prefix}{base}.intermediate.dense", layer["lin1"])
        _linear(sd, f"{prefix}{base}.output.dense", layer["lin2"])
    return sd


def state_dict_from_jax(
    params: Mapping, batch_stats: Mapping, size: int, data_parallel: bool = True
) -> Dict[str, torch.Tensor]:
    """JAX R3M pytrees (numpy leaves) -> the reference's torch state dict.

    `params` is ``{"convnet": ..., "lang_rew": ... (optional)}`` and `batch_stats` the
    convnet's BN statistics (empty for a ViT), as the JAX package holds them. Keys carry
    ``module.convnet.`` (``convnet.`` with ``data_parallel=False``), the layout a
    reference ``model.pt`` stores and `R3MEncoder` loads once the prefix is gone.
    """
    pre = "module." if data_parallel else ""
    if size == 0:
        sd = vit_state(params["convnet"], prefix=f"{pre}convnet.")
    else:
        sd = resnet_state(params["convnet"], batch_stats, size, prefix=f"{pre}convnet.")
    if params.get("lang_rew") is not None:
        for i, layer in zip((0, 2, 4, 6, 8), params["lang_rew"]["layers"]):
            _linear(sd, f"{pre}lang_rew.pred.{i}", layer)
    return sd


def model_from_jax(cfg: R3MConfig, params: Mapping, batch_stats: Mapping) -> R3MModel:
    """A JAX train state's ``params`` (``{"convnet", "lang_rew"?}``) and ``batch_stats``
    (numpy leaves, unpacked BatchNorm) as an `R3MModel` on the CPU."""
    model = R3MModel(cfg)
    sd = state_dict_from_jax(params, batch_stats, cfg.size, data_parallel=False)
    model.load_state_dict(sd)
    return model


def policy_params_from_jax(params) -> torch.nn.ModuleList:
    """The JAX BC probe's policy (``[{"w": [in, out], "b": [out]}, ...]``, numpy leaves) as
    the port's: an ``nn.ModuleList`` of ``nn.Linear`` on the CPU, ``weight = w.T``."""
    layers = torch.nn.ModuleList()
    for p in params:
        w, b = _t(p["w"]), _t(p["b"])
        layer = torch.nn.Linear(*w.shape, device="meta").to_empty(device="cpu")
        with torch.no_grad():
            layer.weight.copy_(w.T)
            layer.bias.copy_(b)
        layers.append(layer)
    return layers


# HF ViTModel module names under ``encoder.layer.{i}.`` -> the JAX layer's keys.
_VIT_LAYER = {
    "layernorm_before": "ln1", "attention.attention.query": "q",
    "attention.attention.key": "k", "attention.attention.value": "v",
    "attention.output.dense": "o", "layernorm_after": "ln2",
    "intermediate.dense": "lin1", "output.dense": "lin2",
}
_VIT_TOP = {"embeddings.patch_embeddings.projection": ("patch",), "layernorm": ("final_ln",),
            "pooler.dense": ("pooler",)}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _resnet_module(parts) -> Tuple:
    """``["layer2", "0", "downsample", "1"]`` -> ``("layer2", 0, "downsample", "bn")``."""
    if len(parts) == 1:
        return (parts[0],)
    path = (parts[0], int(parts[1]))
    if parts[2] == "downsample":
        return path + ("downsample", "conv" if parts[3] == "0" else "bn")
    return path + (parts[2],)


def canonical_path(name: str) -> Optional[Tuple[str, Tuple, str]]:
    """Where the `R3MModel` tensor `name` (``convnet.*``, ``lang_rew.*``) lives in the JAX
    package's canonical tree: ``(group, path, layout)``, group ``"params"`` or
    ``"batch_stats"``, path the keys and list indices under it, layout ``"conv"`` (OIHW ->
    HWIO), ``"linear"`` ([out, in] -> [in, out]) or ``"same"``. None for what the tree does
    not hold (BatchNorm's ``num_batches_tracked``)."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "lang_rew":  # lang_rew.pred.{0,2,4,6,8}.weight|bias
        layer = ("lang_rew", "layers", int(parts[2]) // 2)
        return ("params", layer + ("w",), "linear") if leaf == "weight" else (
            "params", layer + ("b",), "same")
    module = ".".join(parts[1:-1])
    if parts[1] in ("embeddings", "encoder", "layernorm", "pooler"):  # HF ViTModel
        if module == "embeddings":
            return "params", ("convnet", {"cls_token": "cls"}.get(leaf, "pos")), "same"
        if parts[1] == "encoder":  # encoder.layer.{i}.<module>.weight|bias
            path = ("convnet", "layers", int(parts[3]), _VIT_LAYER[".".join(parts[4:-1])])
        else:
            path = ("convnet",) + _VIT_TOP[module]
        if path[-1] in ("ln1", "ln2", "final_ln"):
            return "params", path + ({"weight": "scale"}.get(leaf, "bias"),), "same"
        if leaf == "bias":
            return "params", path + ("b",), "same"
        return "params", path + ("w",), "conv" if path[-1] == "patch" else "linear"
    path = ("convnet",) + _resnet_module(parts[1:-1])
    if path[-1].startswith("conv"):
        return "params", path + ("w",), "conv"
    if leaf not in _BN_LEAF:
        return None
    group, key = _BN_LEAF[leaf]
    return group, (path if group == "params" else path[1:]) + (key,), "same"


def to_canonical(x: torch.Tensor, layout: str) -> np.ndarray:
    """A port tensor as the JAX package holds it: an f32 numpy copy, which later in-place
    updates of `x` (a train step on the CPU) do not reach."""
    a = x.detach().to("cpu", torch.float32, copy=True).numpy()
    if layout == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    return np.ascontiguousarray(a.T) if layout == "linear" else a


def from_canonical(a: np.ndarray, layout: str) -> torch.Tensor:
    """The inverse of `to_canonical`."""
    a = np.asarray(a, np.float32)
    if layout == "conv":
        a = a.transpose(3, 2, 0, 1)
    elif layout == "linear":
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def _set(tree: Dict, path: Tuple, value) -> None:
    """Put `value` at `path` (keys and list indices) into nested dicts and lists."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            node[key] = empty if node[key] is None else node[key]
        else:
            node.setdefault(key, empty)
        node = node[key]
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def get_path(tree, path: Tuple):
    for key in path:
        tree = tree[key]
    return tree


def canonical_tree(named: Iterable[Tuple[str, torch.Tensor]], group: str = "params") -> Dict:
    """The JAX package's canonical tree of `group` from named `R3MModel` tensors: its
    params (``{"convnet", "lang_rew"?}``) from parameters, or anything laid out as they are
    (Adam's moments, LARS's trace); its batch stats from the BatchNorm buffers."""
    tree: Dict = {}
    for name, x in named:
        where = canonical_path(name)
        if where is not None and where[0] == group:
            _set(tree, where[1], to_canonical(x, where[2]))
    return tree


def distilbert_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DistilBERT pytree (``embeddings{word,pos,ln}``, ``layers[q,k,v,o,sa_ln,lin1,
    lin2,out_ln]``) -> HF ``DistilBertModel`` state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def ln(key, p):
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])

    emb = params["embeddings"]
    sd["embeddings.word_embeddings.weight"] = _t(emb["word"])
    sd["embeddings.position_embeddings.weight"] = _t(emb["pos"])
    ln("embeddings.LayerNorm", emb["ln"])
    names = {"q": "attention.q_lin", "k": "attention.k_lin", "v": "attention.v_lin",
             "o": "attention.out_lin", "lin1": "ffn.lin1", "lin2": "ffn.lin2"}
    for i, layer in enumerate(params["layers"]):
        base = f"transformer.layer.{i}"
        for key, name in names.items():
            _linear(sd, f"{base}.{name}", layer[key])
        ln(f"{base}.sa_layer_norm", layer["sa_ln"])
        ln(f"{base}.output_layer_norm", layer["out_ln"])
    return sd


def distilbert_from_jax(params: Mapping, n_heads: int = 12) -> DistilBert:
    """A JAX DistilBERT pytree as a frozen `DistilBert` on the CPU. Every dimension comes
    from the shapes; `n_heads`, which none shows, is the caller's (`load_bert` passes the
    snapshot's ``bert_config``)."""
    return bert_from_state(distilbert_state_from_jax(params), config_from_params(params, n_heads))


def distilbert_tree(sd: StateDict) -> Dict[str, Any]:
    """The JAX package's DistilBERT pytree (f32 numpy) from an HF ``DistilBertModel`` state
    dict, ``DistilBertFor*`` saves included: the port of the JAX ``convert_distilbert``."""
    sd = _normalize_hf_state(sd)
    cfg = distilbert_config_from_state(sd)

    def a(key):
        return np.asarray(torch.as_tensor(sd[key]).detach().cpu().numpy(), dtype=np.float32)

    def lin(key):
        return {"w": a(f"{key}.weight").T, "b": a(f"{key}.bias")}

    def ln(key):
        return {"scale": a(f"{key}.weight"), "bias": a(f"{key}.bias")}

    layers = []
    for i in range(cfg.n_layers):
        base = f"transformer.layer.{i}"
        layers.append({
            "q": lin(f"{base}.attention.q_lin"), "k": lin(f"{base}.attention.k_lin"),
            "v": lin(f"{base}.attention.v_lin"), "o": lin(f"{base}.attention.out_lin"),
            "sa_ln": ln(f"{base}.sa_layer_norm"), "lin1": lin(f"{base}.ffn.lin1"),
            "lin2": lin(f"{base}.ffn.lin2"), "out_ln": ln(f"{base}.output_layer_norm"),
        })
    return {"embeddings": {"word": a("embeddings.word_embeddings.weight"),
                           "pos": a("embeddings.position_embeddings.weight"),
                           "ln": ln("embeddings.LayerNorm")},
            "layers": layers}


def remove_language_head(sd: StateDict) -> Dict[str, Any]:
    """Drop lang_enc/lang_rew entries (reference r3m/__init__.py:35-42)."""
    return {k: v for k, v in sd.items() if "lang_enc" not in k and "lang_rew" not in k}


_LANG_REW_KEYS = [f"lang_rew.pred.{i}.{p}" for i in (0, 2, 4, 6, 8) for p in ("weight", "bias")]


def convert_language_stack(sd: StateDict) -> Dict[str, Any]:
    """The language parts of a prefix-stripped R3M state dict, in the port's torch names:
    ``{"lang_rew": LanguageReward state dict (pred.*) | None, "lang_enc": {"state": HF
    DistilBertModel state dict, "cfg": DistilBertConfig} | None}``.

    The head counts only when all five ``lang_rew.pred.{0,2,4,6,8}`` Linears are there
    (stray keys of a partly stripped artifact are no head). A language-trained reference
    snapshot embeds its frozen DistilBERT under ``lang_enc.model.`` (the reference
    registers LangEncoder as a submodule, models_r3m.py:70), with 12 heads assumed.
    """
    out: Dict[str, Any] = {"lang_rew": None, "lang_enc": None}
    if all(k in sd for k in _LANG_REW_KEYS):
        out["lang_rew"] = {k[len("lang_rew."):]: torch.as_tensor(sd[k]) for k in _LANG_REW_KEYS}
    prefix = "lang_enc.model."
    enc = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if enc:
        out["lang_enc"] = {"state": enc, "cfg": distilbert_config_from_state(enc)}
    return out


def main(argv=None) -> int:
    """Convert checkpoints between the reference torch format and native ``.npz``.

        python -m r3m_tpu_torch.convert to-native snapshot.pt out.npz
        python -m r3m_tpu_torch.convert to-torch  snapshot.npz out.pt

    to-native builds a train state to the bundle's backbone, crop size and head (its widths
    read from the weights), with a fresh optimizer (torch Adam state does not carry over),
    and writes it as a train snapshot with its config; to-torch writes the reference's
    pickled ``{"r3m", "global_step"}`` payload (``module.convnet.*`` names). The state
    passes through ``--device`` (default cuda).
    """
    import argparse
    import dataclasses
    from types import SimpleNamespace

    from r3m_tpu_torch.checkpoint import (
        export_torch_snapshot,
        import_bundle_to_state,
        load_snapshot,
        load_torch_checkpoint,
        r3m_config_from_meta,
        save_snapshot,
        train_tree,
    )
    from r3m_tpu_torch.models.r3m import resolve_device
    from r3m_tpu_torch.training.trainer import create_train_state

    p = argparse.ArgumentParser(prog="python -m r3m_tpu_torch.convert",
                                description=main.__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd, what in (("to-native", "torch snapshot/model.pt -> .npz"),
                      ("to-torch", "native .npz snapshot -> torch .pt")):
        sp = sub.add_parser(cmd, help=what)
        sp.add_argument("src")
        sp.add_argument("out")
        sp.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.cmd == "to-native":
        bundle = load_torch_checkpoint(args.src, include_language=True)
        cfg = R3MConfig(
            size=bundle["size"],
            # a ViT's position table fixes the crop size, and so the template's shapes
            image_size=bundle["image_size"] or R3MConfig.image_size,
        )
        if bundle["lang_rew"] is not None:  # the template's head is the bundle's
            hidden, width = bundle["lang_rew"]["pred.0.weight"].shape
            cfg = dataclasses.replace(cfg, langweight=1.0, hidden_dim=int(hidden),
                                      lang_dim=int(width) - 2 * cfg.out_dim)
        state = import_bundle_to_state(bundle, create_train_state(cfg, 0, device=device))
        save_snapshot(args.out, train_tree(state, cfg),
                      {"global_step": state.step, "config": dataclasses.asdict(cfg)})
    else:
        tree, meta = load_snapshot(args.src)
        params = tree["params"]
        cfg = r3m_config_from_meta(meta, langweight=1.0 if "lang_rew" in params else 0.0)
        model = model_from_jax(cfg, params, tree.get("batch_stats", {})).to(device)
        export_torch_snapshot(
            args.out, SimpleNamespace(model=model, step=int(meta.get("global_step", 0))))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
