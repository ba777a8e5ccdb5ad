"""Frozen DistilBERT sentence encoder, the port of ``r3m_tpu/models/distilbert.py``.

The reference's `LangEncoder` (``models_language.py:13-35``): a frozen pretrained
``distilbert-base-uncased`` whose ``last_hidden_state`` is mean-pooled over the token axis,
padding tokens included (the reference pools with ``.mean(1)`` over the padded batch).
`DistilBert` is an ``nn.Module`` with HF ``DistilBertModel`` state-dict names, so an HF
save loads as it is; `distilbert_state_from_jax` in ``r3m_tpu_torch.convert`` carries the
JAX package's pytree over. `load_bert` reads either file (a JAX-format ``distilbert.npz``
or an HF torch state dict) into a frozen module on the device.

Eval mode only, f32, never differentiated: post-LayerNorm layers (eps 1e-12), exact
(erf) GELU, learned position embeddings, an additive ``finfo(float32).min`` mask on padded
key positions and softmax in f32, as HF computes it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12


BASE = DistilBertConfig()


def _linear(cin: int, cout: int) -> nn.Linear:
    m = nn.Linear(cin, cout)
    nn.init.normal_(m.weight, std=0.02)
    nn.init.zeros_(m.bias)
    return m


class _Layer(nn.Module):
    def __init__(self, cfg: DistilBertConfig):
        super().__init__()
        self.attention = nn.Module()
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            setattr(self.attention, name, _linear(cfg.dim, cfg.dim))
        self.sa_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.ffn = nn.Module()
        self.ffn.lin1 = _linear(cfg.dim, cfg.hidden_dim)
        self.ffn.lin2 = _linear(cfg.hidden_dim, cfg.dim)
        self.output_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)


class DistilBert(nn.Module):
    """HF ``DistilBertModel`` layout; random weights N(0, 0.02) from torch's global
    generator (real weights come from an HF state dict)."""

    def __init__(self, cfg: DistilBertConfig = BASE):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.embeddings.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        for emb in (self.embeddings.word_embeddings, self.embeddings.position_embeddings):
            nn.init.normal_(emb.weight, std=0.02)
        self.embeddings.LayerNorm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.transformer = nn.Module()
        self.transformer.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.n_layers))
        self.requires_grad_(False)
        self.eval()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``[B, T]`` ids and ``[B, T]`` {0, 1} mask -> last_hidden_state ``[B, T, dim]``."""
        cfg = self.cfg
        b, t = input_ids.shape
        if t > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {t} exceeds the position-embedding table "
                f"({cfg.max_position_embeddings}); truncate or retokenize"
            )
        emb = self.embeddings
        x = emb.word_embeddings(input_ids) + emb.position_embeddings.weight[:t][None]
        x = emb.LayerNorm(x)
        heads, d = cfg.n_heads, cfg.dim // cfg.n_heads
        neg = torch.finfo(torch.float32).min
        add_mask = torch.where(attention_mask[:, None, None, :] == 0, neg, 0.0)

        def split(y):
            return y.reshape(b, t, heads, d).transpose(1, 2)

        for layer in self.transformer.layer:
            att = layer.attention
            q, k, v = split(att.q_lin(x)), split(att.k_lin(x)), split(att.v_lin(x))
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d) + add_mask
            ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
            ctx = ctx.transpose(1, 2).reshape(b, t, cfg.dim)
            x = layer.sa_layer_norm(x + att.out_lin(ctx))
            h = F.gelu(layer.ffn.lin1(x))
            x = layer.output_layer_norm(x + layer.ffn.lin2(h))
        return x


@torch.no_grad()
def sentence_embedding(
    model: DistilBert, input_ids: torch.Tensor, attention_mask: torch.Tensor
) -> torch.Tensor:
    """The reference's pooling: the plain mean over ALL tokens, padding included, so the
    embedding depends on the padded length (callers pad to a fixed length)."""
    return model(input_ids, attention_mask).mean(dim=1)


def bert_from_state(sd: Mapping[str, torch.Tensor], cfg: DistilBertConfig) -> DistilBert:
    """A frozen `DistilBert` of `cfg` holding the HF-named f32 tensors of `sd`, on the CPU;
    keys `cfg` does not use (an old save's ``embeddings.position_ids``) are ignored."""
    with torch.device("meta"):
        model = DistilBert(cfg)
    missing = [k for k in model.state_dict() if k not in sd]
    if missing:
        raise ValueError(f"DistilBERT state dict lacks {missing[:3]} ({len(missing)} keys)")
    model.load_state_dict(
        {k: torch.as_tensor(sd[k]).to(torch.float32) for k in model.state_dict()}, assign=True)
    return model


def _normalize_hf_state(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Accept ``DistilBertFor*`` saves: the bare encoder lives under a ``distilbert.``
    prefix there, which comes off so the plain ``DistilBertModel`` layout applies."""
    if "embeddings.word_embeddings.weight" not in sd and any(
            k.startswith("distilbert.") for k in sd):
        return {k[len("distilbert."):]: v for k, v in sd.items() if k.startswith("distilbert.")}
    return dict(sd)


def distilbert_config_from_state(sd: Mapping[str, Any], n_heads: int = 12) -> DistilBertConfig:
    """The architecture of an HF ``DistilBertModel`` state dict. Every dimension comes from
    the shapes except `n_heads`, which none shows (12 in distilbert-base, the only encoder
    the reference loads, models_language.py:18-21)."""
    sd = _normalize_hf_state(sd)
    vocab, dim = sd["embeddings.word_embeddings.weight"].shape
    layer_ids = [int(m.group(1)) for k in sd
                 if (m := re.match(r"transformer\.layer\.(\d+)\.", k))]
    if not layer_ids:
        raise ValueError(
            "state dict has no transformer.layer.* keys — expected an HF "
            "DistilBertModel layout (embeddings.* + transformer.layer.N.*); "
            f"got keys like {sorted(sd)[:3]}"
        )
    return DistilBertConfig(
        vocab_size=int(vocab),
        dim=int(dim),
        n_layers=1 + max(layer_ids),
        n_heads=n_heads,
        hidden_dim=int(sd["transformer.layer.0.ffn.lin1.weight"].shape[0]),
        max_position_embeddings=int(sd["embeddings.position_embeddings.weight"].shape[0]),
    )


def config_from_params(params: Mapping, n_heads: int = 12) -> DistilBertConfig:
    """The architecture of the JAX package's DistilBERT pytree (``embeddings{word,pos,ln}``,
    ``layers[...]``), as `distilbert_config_from_state` reads a state dict; prefer the
    ``bert_config`` metadata of a snapshot, which also holds `n_heads`."""
    vocab, dim = np.shape(params["embeddings"]["word"])
    return DistilBertConfig(
        vocab_size=int(vocab),
        dim=int(dim),
        n_layers=len(params["layers"]),
        n_heads=n_heads,
        hidden_dim=int(np.shape(params["layers"][0]["lin1"]["w"])[1]),
        max_position_embeddings=int(np.shape(params["embeddings"]["pos"])[0]),
    )


def load_bert(path: str, device=None) -> DistilBert:
    """Frozen DistilBERT weights from `path` as a `DistilBert` on `device` (``"cuda"``
    unless given); the port of ``load_bert_params`` (``r3m_tpu/training/workspace.py``).

    A ``.npz`` is a snapshot of the JAX package's pytree (as `r3m_tpu_torch.prepare_language`
    writes it): its ``bert_config`` metadata gives the architecture, `n_heads` included;
    without it the shapes do, with 12 heads. Any other file is an HF torch state dict
    (``DistilBertModel`` or ``DistilBertFor*``), 12 heads.
    """
    from r3m_tpu_torch.checkpoint import load_snapshot
    from r3m_tpu_torch.convert import distilbert_state_from_jax
    from r3m_tpu_torch.models.r3m import resolve_device

    device = resolve_device(device)
    if path.endswith(".npz"):
        tree, meta = load_snapshot(path)
        bert_config = meta.get("bert_config")
        cfg = DistilBertConfig(**bert_config) if bert_config else config_from_params(tree)
        sd = distilbert_state_from_jax(tree)
    else:
        sd = _normalize_hf_state(torch.load(path, map_location="cpu", weights_only=True))
        cfg = distilbert_config_from_state(sd)
    return bert_from_state(sd, cfg).to(device)
