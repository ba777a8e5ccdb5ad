"""One-command parity check: a published torch checkpoint against the port; the port of
``r3m_tpu/verify_parity.py``.

    python -m r3m_tpu_torch.verify_parity <model.pt> [config.yaml] [--images N] [--device D]

Loads the artifact twice: through the port's serving chain (`load_r3m_from_files`, on
``--device``, default cuda) and through an executable torch reference on the CPU (real
torchvision where installed, else the architecture-faithful `r3m_tpu_torch.torch_oracle`;
HF ``ViTModel`` for a ViT), runs both on the same seeded images with the reference's
preprocessing, and prints one JSON line of cosine statistics against the bar (0.999). An
artifact that carries the language stack (``lang_enc.model.*`` and ``lang_rew.pred.*``)
also gets its rewards compared with HF ``DistilBertModel`` and the reference's MLP. A native
``.npz`` has no torch reference: it runs convert-only (a finite forward). The exit code is
0 when ``ok``, else 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

COSINE_BAR = 0.999


def _load_torch_reference_state(modelpath: str):
    """The prefix-stripped state dict of the artifact for the reference side, read on its
    own (the port's loader is what is under test); None for a native ``.npz``."""
    from r3m_tpu_torch.checkpoint import load_torch_payload, torch_payload_state_dict
    from r3m_tpu_torch.convert import strip_prefix

    try:
        payload = load_torch_payload(modelpath)
    except Exception as torch_err:
        # a native snapshot is a valid input without torch-reference weights; anything
        # that is neither a torch pickle nor an npz raises its own error
        try:
            np.load(modelpath, allow_pickle=False).close()
        except Exception:
            raise torch_err
        print(f"[verify_parity] {modelpath} is a native snapshot, not a torch artifact — "
              "torch-reference forward skipped", file=sys.stderr)
        return None
    return strip_prefix(torch_payload_state_dict(payload))


def _torch_forward(full_sd, images: np.ndarray) -> Optional[np.ndarray]:
    """The reference's forward on the CPU: /255, ImageNet normalisation, the oracle ResNet
    (None where its weights do not load)."""
    from r3m_tpu_torch.convert import detect_resnet_size, remove_language_head
    from r3m_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
    from r3m_tpu_torch.torch_oracle import torch_resnet

    sd = remove_language_head(dict(full_sd))
    sd = {k[len("convnet."):]: v for k, v in sd.items() if k.startswith("convnet.")}
    if "embeddings.cls_token" in sd:
        return _torch_vit_forward(sd, images)
    model = torch_resnet(detect_resnet_size(sd)).eval()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # hand-written oracles have no num_batches_tracked; anything else missing means the
    # torch side cannot serve as a reference
    real_missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if real_missing or unexpected:
        print(f"[verify_parity] torch reference load mismatch — missing={real_missing[:5]} "
              f"unexpected={list(unexpected)[:5]}", file=sys.stderr)
        return None
    x = torch.from_numpy(images) / 255.0
    mean = torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)
    with torch.no_grad():
        return model((x - mean) / std).numpy()


def _torch_vit_forward(sd, images: np.ndarray) -> Optional[np.ndarray]:
    """The reference's ViT forward (size 0): transformers ``ViTModel`` and 0.5/0.5
    normalisation (models_r3m.py:52-61); None without `transformers`."""
    try:
        from transformers import ViTConfig as HFConfig, ViTModel
    except ImportError:
        return None
    from r3m_tpu_torch.models.vit import vit_config_from_state
    from r3m_tpu_torch.ops.image import VIT_MEAN, VIT_STD

    cfg = vit_config_from_state(sd)
    model = ViTModel(
        HFConfig(hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
                 num_attention_heads=cfg.n_heads, intermediate_size=cfg.hidden_dim,
                 image_size=cfg.image_size, patch_size=cfg.patch_size,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        add_pooling_layer=True,
    ).eval()
    try:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    except RuntimeError as e:
        print(f"[verify_parity] torch ViT reference load mismatch — {e}", file=sys.stderr)
        return None
    x = torch.from_numpy(images) / 255.0
    mean = torch.tensor(VIT_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(VIT_STD).view(1, 3, 1, 1)
    with torch.no_grad():
        return model((x - mean) / std).pooler_output.numpy()


def _language_parity(sd, device, seed: int = 0, n: int = 4) -> Optional[Dict]:
    """The language path: the artifact's embedded DistilBERT and reward head through the
    port (`convert_language_stack`, `DistilBert`, `LanguageReward`, on `device`, true f32)
    and through HF ``DistilBertModel`` with the reference's MLP on the CPU, on the same
    seeded (e0, es, tokens). None without a language stack or without `transformers`."""
    try:
        from transformers import DistilBertConfig as HFConfig, DistilBertModel
    except ImportError:
        return None
    from r3m_tpu_torch.convert import convert_language_stack
    from r3m_tpu_torch.models.distilbert import bert_from_state, sentence_embedding
    from r3m_tpu_torch.models.language_reward import language_reward_from_state
    from r3m_tpu_torch.models.r3m import full_f32
    from r3m_tpu_torch.torch_oracle import TorchLanguageReward

    bundle = convert_language_stack(sd)
    if bundle["lang_rew"] is None or bundle["lang_enc"] is None:
        return None
    cfg = bundle["lang_enc"]["cfg"]
    rng = np.random.default_rng(seed)
    t = 12
    ids = rng.integers(0, cfg.vocab_size, size=(n, t)).astype(np.int64)
    lens = rng.integers(3, t + 1, size=(n,))
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int64)
    hidden, width = bundle["lang_rew"]["pred.0.weight"].shape
    out_dim = int(width - cfg.dim) // 2
    e0 = rng.standard_normal((n, out_dim)).astype(np.float32)
    es = rng.standard_normal((n, out_dim)).astype(np.float32)

    bert = bert_from_state(bundle["lang_enc"]["state"], cfg).to(device)
    head = language_reward_from_state(bundle["lang_rew"], out_dim).to(device)
    with torch.inference_mode(), full_f32():
        lang = sentence_embedding(bert, *(torch.from_numpy(a).to(device) for a in (ids, mask)))
        ours = head(*(torch.from_numpy(a).to(device) for a in (e0, es)), lang)
        ours = ours.cpu().numpy().astype(np.float64)

    enc_prefix, rew_prefix = "lang_enc.model.", "lang_rew."
    hf = DistilBertModel(
        HFConfig(vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
                 n_heads=cfg.n_heads, hidden_dim=cfg.hidden_dim,
                 max_position_embeddings=cfg.max_position_embeddings)
    ).eval()
    ref_head = TorchLanguageReward(out_dim, hidden, cfg.dim).eval()
    try:
        hf.load_state_dict(
            {k[len(enc_prefix):]: v for k, v in sd.items() if k.startswith(enc_prefix)})
        ref_head.load_state_dict(
            {k[len(rew_prefix):]: v for k, v in sd.items() if k.startswith(rew_prefix)})
    except RuntimeError as e:
        # e.g. a transformers-version key-set mismatch: degrade as the vision side does
        print(f"[verify_parity] torch language reference load mismatch — {e}",
              file=sys.stderr)
        return None
    with torch.no_grad():
        t_le = hf(torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask)).last_hidden_state.mean(1)
        ref = ref_head(torch.from_numpy(e0), torch.from_numpy(es), t_le).numpy()
    diff = float(np.max(np.abs(ours - ref)))
    return {"lang_max_abs_diff": diff,
            "lang_ok": bool(diff < 1e-3 * max(1.0, float(np.max(np.abs(ref)))))}


def verify_parity(
    modelpath: str,
    configpath: Optional[str] = None,
    n_images: int = 8,
    seed: int = 0,
    image_size: Optional[int] = None,
    device=None,
) -> Dict:
    """Run the check and return its statistics (which `main` prints).

    The probe images are drawn at the model's own crop size (224 for the published
    checkpoints), so both sides apply only /255 and the normalisation; another
    `image_size` would run the port's Resize(256)+CenterCrop on one side only, so it runs
    convert-only.
    """
    from r3m_tpu_torch import load_r3m_from_files

    enc = load_r3m_from_files(modelpath, configpath, device=device)
    if image_size is None:
        image_size = enc.cfg.image_size
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, size=(n_images, 3, image_size, image_size))
    images = images.astype(np.float32)

    ours = enc(images).cpu().numpy().astype(np.float64)
    result: Dict = {
        "model": modelpath,
        "size": enc.cfg.size,
        "out_dim": int(ours.shape[-1]),
        "images": n_images,
        "bar": COSINE_BAR,
        "device": str(enc.device),
    }
    if image_size != enc.cfg.image_size:
        result.update({
            "mode": "convert-only",
            "ok": bool(np.all(np.isfinite(ours))),
            "note": f"image_size {image_size} != native {enc.cfg.image_size}; "
            "preprocessing would differ between paths — finite-forward check only",
        })
        return result

    ref_sd = _load_torch_reference_state(modelpath)
    ref = None if ref_sd is None else _torch_forward(ref_sd, images)
    if ref is None:
        result.update({
            "mode": "convert-only",
            "ok": bool(np.all(np.isfinite(ours))),
            "note": "no torch reference for this artifact (transformers absent for a ViT, "
            "load mismatch, or a native snapshot); checked conversion + finite forward only",
        })
    else:
        ref = ref.astype(np.float64)
        cos = np.sum(ours * ref, -1) / (np.linalg.norm(ours, axis=-1)
                                         * np.linalg.norm(ref, axis=-1))
        result.update({
            "mode": "torch-reference",
            "cosine_min": float(np.min(cos)),
            "cosine_mean": float(np.mean(cos)),
            "max_abs_diff": float(np.max(np.abs(ours - ref))),
            "ok": bool(np.min(cos) >= COSINE_BAR),
        })
    # a vision-reference fallback must not silence a language-stack regression
    lang = None if ref_sd is None else _language_parity(ref_sd, enc.device, seed=seed)
    if lang is not None:
        result.update(lang)
        result["ok"] = bool(result["ok"] and lang["lang_ok"])
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m r3m_tpu_torch.verify_parity",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("modelpath", help="a torch model.pt / snapshot.pt, or a native .npz")
    p.add_argument("configpath", nargs="?", default=None)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=None,
                   help="probe image size (default: the model's own crop size; another "
                   "size runs convert-only)")
    p.add_argument("--device", default="cuda",
                   help="device of the port's side (default cuda); the reference runs on "
                   "the CPU")
    a = p.parse_args(argv)
    result = verify_parity(a.modelpath, a.configpath, a.images, a.seed, a.image_size,
                           a.device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
