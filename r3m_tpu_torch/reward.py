"""Language-conditioned reward scoring, the port of ``r3m_tpu/reward.py``.

Users of the reference call ``model.module.get_reward(e0, es, sentences)`` on a
language-trained R3M (``models_r3m.py:78-81``): the frozen DistilBERT encodes the
instruction, and the trained `LanguageReward` MLP scores how much progress the (start,
current) embedding pair makes toward it. `R3MRewardModel` packages that for inference, from
a native training snapshot (which, unlike the stripped `load_r3m` artifacts, still carries
``lang_rew``) or from a reference torch training snapshot (`from_torch_snapshot`):

    rm = R3MRewardModel.from_snapshot("snapshot.npz", bert_weights, vocab)
    r = rm.get_reward(e0, es, ["pick up the cup"])      # embeddings
    r = rm(images0, images_t, ["pick up the cup"])      # images
    curve = rm.reward_curve(frames, "pick up the cup")  # one trajectory

The images go through the port's `R3MEncoder` (parity or fast precision, so the ResNet stem
pool or the ViT attention kernel runs on the card); DistilBERT and the reward MLP run in
true f32 in both precisions (`full_f32`), so a caller's TF32 flags cannot move a reward.
Weights go to the device once, at construction; sentences are tokenized on the host, and
the ids and mask go over in one copy a query. Outputs are f32 tensors on the device.

Padding changes the result: DistilBERT sentence embeddings mean-pool over ALL tokens,
padding included (models_language.py:34). ``pad_mode="fixed"`` pads to `lang_max_len`, as
this framework's training pipeline does; ``"longest"`` pads to the batch's longest sentence,
the reference tokenizer's ``padding=True`` (models_language.py:30), which heads trained by
the reference need.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from r3m_tpu_torch.models.distilbert import (
    DistilBert,
    bert_from_state,
    load_bert,
    sentence_embedding,
)
from r3m_tpu_torch.models.language_reward import language_reward_from_state
from r3m_tpu_torch.models.r3m import R3MConfig, R3MEncoder, full_f32, resolve_device
from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer


class R3MRewardModel:
    """Frozen image encoder, DistilBERT and `LanguageReward`, scoring on one device.

    `state_dict`: an `R3MModel`'s tensors, ``convnet.*`` and ``lang_rew.pred.*`` (the
    reference's names without ``module.``); `bert` the frozen `DistilBert`. `device` is
    ``"cuda"`` unless given.
    """

    def __init__(
        self,
        cfg: R3MConfig,
        state_dict: Mapping[str, torch.Tensor],
        bert: DistilBert,
        tokenizer: WordPieceTokenizer,
        lang_max_len: int = 32,
        pad_mode: str = "fixed",
        precision: str = "parity",
        device=None,
    ):
        head = {k[len("lang_rew."):]: v for k, v in state_dict.items()
                if k.startswith("lang_rew.")}
        if not head:
            raise ValueError("snapshot has no language head (trained with langweight=0?)")
        if pad_mode not in ("fixed", "longest"):
            raise ValueError(f"pad_mode must be 'fixed'|'longest': {pad_mode!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.tokenizer = tokenizer
        self.lang_max_len = lang_max_len
        self.pad_mode = pad_mode
        convnet = {k[len("convnet."):]: v for k, v in state_dict.items()
                   if k.startswith("convnet.")}
        self._encoder = R3MEncoder(cfg, convnet, precision=precision, device=device)
        self.lang_rew = (language_reward_from_state(head, cfg.out_dim).to(device)
                         .requires_grad_(False).eval())
        self.bert = bert.to(device).requires_grad_(False).eval()

    @classmethod
    def from_snapshot(
        cls,
        snapshot_path: str,
        bert_weights: str,
        vocab_path: str,
        lang_max_len: Optional[int] = None,
        pad_mode: str = "fixed",
        precision: str = "parity",
        device=None,
    ) -> "R3MRewardModel":
        """From a native ``.npz`` training snapshot of either package (config in its
        metadata) and DistilBERT weights (`load_bert`).

        ``lang_max_len=None`` takes the length the training run padded to from the
        snapshot's metadata (32 without): serving with another would shift the sentence
        embeddings the head was trained on.
        """
        from r3m_tpu_torch.checkpoint import load_snapshot, r3m_config_from_meta
        from r3m_tpu_torch.convert import state_dict_from_jax

        device = resolve_device(device)
        tree, meta = load_snapshot(snapshot_path)
        # serving is f32 (or fast) whatever dtype the run trained in
        cfg = r3m_config_from_meta(meta, compute_dtype="float32")
        if lang_max_len is None:
            lang_max_len = int(meta.get("lang_max_len", 32))
        sd = state_dict_from_jax(tree["params"], tree.get("batch_stats", {}), cfg.size,
                                 data_parallel=False)
        return cls(cfg, sd, load_bert(bert_weights, device),
                   WordPieceTokenizer(vocab_file=vocab_path), lang_max_len=lang_max_len,
                   pad_mode=pad_mode, precision=precision, device=device)

    @classmethod
    def from_torch_snapshot(
        cls,
        snapshot_path: str,
        bert_weights: Optional[str],
        vocab_path: str,
        pad_mode: str = "longest",
        precision: str = "parity",
        device=None,
    ) -> "R3MRewardModel":
        """From a reference torch training snapshot (``snapshot.pt``): the backbone, its
        BatchNorm statistics and the ``lang_rew`` head.

        ``bert_weights=None`` uses the DistilBERT the snapshot embeds (``lang_enc.model.*``:
        the reference registers the frozen encoder as a submodule, models_r3m.py:70); a path
        overrides it. ``pad_mode="longest"`` by default, as the reference tokenizes. A ViT's
        crop size comes from its position table.
        """
        from r3m_tpu_torch.checkpoint import load_torch_checkpoint

        device = resolve_device(device)
        bundle = load_torch_checkpoint(snapshot_path, include_language=True)
        if bundle["lang_rew"] is None:
            raise ValueError(f"{snapshot_path} carries no language-reward head")
        if bert_weights is not None:
            bert = load_bert(bert_weights, device)
        elif bundle["lang_enc"] is not None:
            bert = bert_from_state(bundle["lang_enc"]["state"], bundle["lang_enc"]["cfg"])
        else:
            raise ValueError(
                f"{snapshot_path} embeds no lang_enc DistilBERT; pass "
                "bert_weights=<distilbert.npz> (see r3m_tpu_torch.prepare_language)"
            )
        cfg = R3MConfig(size=bundle["size"], langweight=1.0, compute_dtype="float32",
                        image_size=bundle["image_size"] or R3MConfig.image_size)
        sd = {**{f"convnet.{k}": v for k, v in bundle["convnet"].items()},
              **{f"lang_rew.{k}": v for k, v in bundle["lang_rew"].items()}}
        return cls(cfg, sd, bert, WordPieceTokenizer(vocab_file=vocab_path),
                   pad_mode=pad_mode, precision=precision, device=device)

    # -- the reference's surface ----------------------------------------------------------

    def embed(self, images) -> torch.Tensor:
        """NCHW images in [0, 255] (numpy or tensor; CHW gets a batch) -> ``[B, D]``
        embeddings: the `load_r3m` path."""
        return self._encoder(images)

    def _sentence_embeddings(self, sentences: Sequence[str]) -> torch.Tensor:
        max_len = None if self.pad_mode == "longest" else self.lang_max_len
        ids, mask = self.tokenizer.encode_batch(list(sentences), max_len)
        ids, mask = torch.from_numpy(np.stack([ids, mask])).to(self.device)
        return sentence_embedding(self.bert, ids, mask)

    def _as_embedding(self, e) -> torch.Tensor:
        return torch.as_tensor(e, dtype=torch.float32, device=self.device)

    def get_reward(self, e0, es, sentences: Sequence[str]) -> torch.Tensor:
        """Score (start, current) embedding pairs ``[N, D]`` against `sentences`
        (models_r3m.py:78-81): ``[N]``."""
        with torch.inference_mode(), full_f32():
            lang = self._sentence_embeddings(sentences)
            return self.lang_rew(self._as_embedding(e0), self._as_embedding(es), lang)

    def __call__(self, images0, images_t, sentences: Sequence[str]) -> torch.Tensor:
        """Score image pairs: ``[N, 3, H, W]`` start and current frames against
        `sentences`. Two batches of one shape go through the encoder as one stacked
        ``[2N]`` pass, so a query pays one launch sequence, not two."""
        obs0, obs_t = (torch.as_tensor(x) for x in (images0, images_t))
        obs0, obs_t = (x[None] if x.ndim == 3 else x for x in (obs0, obs_t))
        if obs0.shape == obs_t.shape and obs0.device == obs_t.device:
            both = self._encoder(torch.cat([obs0, obs_t]))
            e0, es = both[: obs0.shape[0]], both[obs0.shape[0]:]
        else:
            e0, es = self._encoder(obs0), self._encoder(obs_t)
        return self.get_reward(e0, es, sentences)

    def reward_curve(self, frames, sentence: str) -> torch.Tensor:
        """Per-frame progress rewards along one trajectory, ``r_t = R(e_0, e_t, l)`` (the
        paper's reward curves, arXiv:2203.12601 §4.3). `frames` is ``[T, 3, H, W]`` in
        [0, 255]; returns ``[T]`` (index 0 is the degenerate (e_0, e_0) score, the curve's
        baseline). One encoder pass; the sentence is tokenized and encoded once."""
        emb = self.embed(frames)
        with torch.inference_mode(), full_f32():
            lang = self._sentence_embeddings([sentence])
            return self.lang_rew(emb[:1].expand_as(emb), emb, lang.expand(emb.shape[0], -1))

