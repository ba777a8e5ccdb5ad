"""Weight carry between the JAX package's pytrees and the port's torch state dicts.

The port keeps the reference's torch names and layouts, so a reference ``model.pt`` loads
natively. `state_dict_from_jax` turns a JAX numpy pytree (``{"convnet": ...}`` params and
batch stats) into that format: HWIO -> OIHW convolutions, BN scale/bias/mean/var ->
weight/bias/running_mean/running_var, dense ``[in, out]`` -> Linear ``[out, in]``, and the
HF ``ViTModel`` names for size 0. `model_from_jax` carries a JAX train state's params and
batch stats into an `R3MModel`, and `distilbert_state_from_jax` the frozen DistilBERT
pytree into HF ``DistilBertModel`` names (the inverse of the JAX ``convert_distilbert``).
The other way, `canonical_path` names where each `R3MModel` tensor lives in the JAX
package's canonical tree (unpacked BatchNorm, as its snapshots hold it) and how its layout
changes, and `canonical_tree` builds that tree from named tensors: the port's copy of the
JAX ``convert_resnet`` / ``convert_linear`` / ``convert_language_reward`` and ``convert_vit``.
The numpy input is all it reads: it imports nothing of JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from r3m_tpu_torch.models.distilbert import DistilBert, DistilBertConfig
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


def convnet_state(sd: StateDict) -> Tuple[Dict[str, Any], int, Optional[int]]:
    """The backbone of a reference R3M state dict: ``(state dict, size, image size)``.

    Strips ``module.`` and ``convnet.``; the rest (a language head) is left out. `size`
    is 0 for an HF ViT, whose crop size comes from its position table; for a ResNet the
    image size is None.
    """
    sd = strip_prefix(dict(sd))
    enc = {k[len("convnet."):]: v for k, v in sd.items() if k.startswith("convnet.")}
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
    """A port tensor as the JAX package holds it (f32 numpy)."""
    a = x.detach().float().cpu().numpy()
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
    from the shapes except `n_heads`, which none shows (12 in distilbert-base)."""
    vocab, dim = np.shape(params["embeddings"]["word"])
    cfg = DistilBertConfig(
        vocab_size=int(vocab), dim=int(dim), n_layers=len(params["layers"]),
        n_heads=n_heads, hidden_dim=int(np.shape(params["layers"][0]["lin1"]["w"])[1]),
        max_position_embeddings=int(np.shape(params["embeddings"]["pos"])[0]),
    )
    model = DistilBert(cfg)
    model.load_state_dict(distilbert_state_from_jax(params))
    return model
