"""Frozen DistilBERT sentence encoder, the port of ``r3m_tpu/models/distilbert.py``.

The reference's `LangEncoder` (``models_language.py:13-35``): a frozen pretrained
``distilbert-base-uncased`` whose ``last_hidden_state`` is mean-pooled over the token axis,
padding tokens included (the reference pools with ``.mean(1)`` over the padded batch).
`DistilBert` is an ``nn.Module`` with HF ``DistilBertModel`` state-dict names, so an HF
save loads as it is; `distilbert_state_from_jax` in ``r3m_tpu_torch.convert`` carries the
JAX package's pytree over.

Eval mode only, f32, never differentiated: post-LayerNorm layers (eps 1e-12), exact
(erf) GELU, learned position embeddings, an additive ``finfo(float32).min`` mask on padded
key positions and softmax in f32, as HF computes it.
"""

from __future__ import annotations

import dataclasses
import math

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
