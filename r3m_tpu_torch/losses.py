"""R3M loss engine: L1/L2 sparsity, TCN InfoNCE and language-reward InfoNCE, the port of
``r3m_tpu/losses.py``.

The reference's per-step update math (``trainer.py:25-152``), batched: the same epsilon
placement (1e-8 inside and outside the softmax ratio), the same positive and negative
structure, and the same masking (rows with an empty caption are zeroed, and the mean
still divides by the full batch). The language head scores every pair of a step in one
application. Cross-video negatives are explicit permutation index tensors
(`draw_permutations`), drawn from a `torch.Generator`, so tests can hand both packages the
same ones. Losses compute in f32 whatever the encoder's dtype; metric names are the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from r3m_tpu_torch.models.language_reward import LanguageReward
from r3m_tpu_torch.models.r3m import R3MConfig, safe_l2_norm, sim

EPS = 1e-8


def draw_permutations(
    generator: torch.Generator, bs: int, num_neg: int
) -> Dict[str, torch.Tensor]:
    """All cross-video negative permutations of one step, on the generator's device.

    ``{"lang": [num_neg, 3, bs], "tcn": [num_neg, 2, bs]}`` int64: one independent
    `torch.randperm` per (negative round, loss term), as the reference draws them
    (trainer.py:86-92, 135-137). The language draws come first.
    """
    device = generator.device

    def perms(n: int) -> torch.Tensor:
        if n == 0:
            return torch.zeros((0, bs), dtype=torch.int64, device=device)
        return torch.stack(
            [torch.randperm(bs, generator=generator, device=device) for _ in range(n)]
        )

    return {
        "lang": perms(num_neg * 3).reshape(num_neg, 3, bs),
        "tcn": perms(num_neg * 2).reshape(num_neg, 2, bs),
    }


def lp_norms(alles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean L2 / L1 / L0 norms over embeddings ``[N, D]`` (trainer.py:52-54)."""
    alles = alles.to(torch.float32)
    l2 = safe_l2_norm(alles, dim=-1).mean()
    l1 = alles.abs().sum(dim=-1).mean()
    l0 = (alles != 0).to(torch.float32).sum(dim=-1).mean()
    return l2, l1, l0


def _info_nce(pos: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """-log(eps + exp(pos) / (eps + exp(pos) + sum(exp(negs), -1))), trainer.py:101-103;
    `negs` has one more trailing dim than `pos`."""
    ratio = torch.exp(pos) / (EPS + torch.exp(pos) + torch.exp(negs).sum(dim=-1))
    return -torch.log(EPS + ratio)


def language_loss(
    cfg: R3MConfig,
    lang_rew: LanguageReward,
    e0: torch.Tensor,
    eg: torch.Tensor,
    es0: torch.Tensor,
    es1: torch.Tensor,
    es2: torch.Tensor,
    lang_emb: torch.Tensor,
    lang_mask: torch.Tensor,
    perms: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Language-reward InfoNCE (trainer.py:64-118), scored in one MLP pass.

    Per term (the anchor's language is never permuted):
      term1: pos G(e0,eg,l);  negs [G(e0,e0,l)]  + num_neg x G(e0[p],eg[p],l)
      term2: pos G(e0,es1,l); negs [G(e0,es0,l)] + num_neg x G(e0[p],es1[p],l)
      term3: pos G(e0,es2,l); negs [G(e0,es1,l)] + num_neg x G(e0[p],es2[p],l)

    `perms`: ``[num_neg, 3, B]``. `lang_mask`: ``[B]``, 1.0 where the caption is
    non-empty. Returns (rewloss, metrics).
    """
    num_neg = cfg.num_negatives
    bs = e0.shape[0]
    firsts = [e0, e0, e0, e0, e0, e0]
    seconds = [eg, es1, es2, e0, es0, es1]
    for k in range(num_neg):
        for t, second in enumerate((eg, es1, es2)):
            p = perms[k, t]
            firsts.append(e0[p])
            seconds.append(second[p])
    n_pairs = len(firsts)  # 6 + 3 * num_neg
    first = torch.stack(firsts).reshape(n_pairs * bs, -1)
    second = torch.stack(seconds).reshape(n_pairs * bs, -1)
    lang = lang_emb[None].expand(n_pairs, bs, lang_emb.shape[-1]).reshape(n_pairs * bs, -1)
    scores = lang_rew(first, second, lang).reshape(n_pairs, bs).to(torch.float32)

    pos = scores[0:3]  # [3, B]
    within = scores[3:6]  # [3, B]
    cross = scores[6:].reshape(num_neg, 3, bs)
    negs = torch.cat([within[:, :, None], cross.permute(1, 2, 0)], dim=-1)  # [3, B, 1+n]

    rewloss = _info_nce(pos, negs).mean(dim=0)  # (r1 + r2 + r3) / 3
    rewloss = (rewloss * lang_mask).mean()  # masked, mean over the FULL batch
    accs = (negs.amax(dim=-1) < pos).to(torch.float32).mean(dim=-1)
    metrics = {"rewloss": rewloss, "rewacc1": accs[0], "rewacc2": accs[1],
               "rewacc3": accs[2]}
    return rewloss, metrics


def tcn_loss(
    cfg: R3MConfig,
    es0: torch.Tensor,
    es1: torch.Tensor,
    es2: torch.Tensor,
    perms: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Within-video time-contrastive InfoNCE (trainer.py:122-150).

    `perms`: ``[num_neg, 2, B]``; ``perms[k, 0]`` shuffles es0, ``perms[k, 1]`` es2.
    With ``num_negatives == 0`` the cross-video terms vanish (the JAX package's
    extension; the reference raises there). Returns (smoothloss, metrics).
    """
    es0, es1, es2 = (e.to(torch.float32) for e in (es0, es1, es2))
    sim_0_2 = sim(cfg, es2, es0)
    sim_1_2 = sim(cfg, es2, es1)
    sim_0_1 = sim(cfg, es1, es0)
    num_neg = cfg.num_negatives
    if num_neg:
        neg0 = torch.stack([sim(cfg, es0, es0[perms[k, 0]]) for k in range(num_neg)], -1)
        neg2 = torch.stack([sim(cfg, es2, es2[perms[k, 1]]) for k in range(num_neg)], -1)
    else:
        neg0 = neg2 = es0.new_zeros((es0.shape[0], 0))

    # trainer.py:144-145: each term's denominator also holds sim_0_2.
    ratio1 = torch.exp(sim_1_2) / (
        EPS + torch.exp(sim_0_2) + torch.exp(sim_1_2) + torch.exp(neg2).sum(-1)
    )
    ratio2 = torch.exp(sim_0_1) / (
        EPS + torch.exp(sim_0_1) + torch.exp(sim_0_2) + torch.exp(neg0).sum(-1)
    )
    smoothloss = ((-torch.log(EPS + ratio1) - torch.log(EPS + ratio2)) / 2.0).mean()
    aligned = ((sim_0_2 < sim_1_2).to(torch.float32)
               * (sim_0_1 > sim_0_2).to(torch.float32)).mean()
    return smoothloss, {"tcnloss": smoothloss, "aligned": aligned}


def r3m_loss(
    cfg: R3MConfig,
    lang_rew: Optional[LanguageReward],
    embeddings: torch.Tensor,
    lang_emb: Optional[torch.Tensor],
    lang_mask: Optional[torch.Tensor],
    perms: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full per-step loss over encoded embeddings ``[B, 5, D]``, frame order
    (e0, eg, es0, es1, es2) as the data pipeline emits it. Returns (full_loss, metrics).
    """
    emb = embeddings.to(torch.float32)
    bs = emb.shape[0]
    e0, eg, es0, es1, es2 = (emb[:, i] for i in range(5))
    l2l, l1l, l0l = lp_norms(emb.reshape(bs * 5, -1))
    metrics: Dict[str, torch.Tensor] = {"l2loss": l2l, "l1loss": l1l, "l0loss": l0l}
    full_loss = cfg.l2weight * l2l + cfg.l1weight * l1l
    if cfg.langweight > 0:
        rewloss, m = language_loss(
            cfg, lang_rew, e0, eg, es0, es1, es2, lang_emb, lang_mask, perms["lang"]
        )
        metrics.update(m)
        full_loss = full_loss + cfg.langweight * rewloss
    if cfg.tcnweight > 0:
        smoothloss, m = tcn_loss(cfg, es0, es1, es2, perms["tcn"])
        metrics.update(m)
        full_loss = full_loss + cfg.tcnweight * smoothloss
    metrics["full_loss"] = full_loss
    return full_loss, metrics
