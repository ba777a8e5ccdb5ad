"""Batch embedding extraction: image files -> one ``.npz`` of R3M embeddings; the port of
``r3m_tpu/embed.py``.

Users of the reference loop `load_r3m(...)` over demonstration frames one image at a time
(the reference's example.py:19-34). This CLI is that loop for a whole job: collect image
files, run fixed-size batches through one encoder (the tail batch padded to the batch
size and sliced off), and write ``{embeddings [N, D] f32, paths [N] str}`` to an ``.npz``
for BC or reward probing. Decoding needs Pillow, imported where the images are read.

    python -m r3m_tpu_torch.embed --snapshot snap.npz --out emb.npz frames/
    python -m r3m_tpu_torch.embed --model resnet50 --out emb.npz a.jpg b.jpg
    python -m r3m_tpu_torch.embed --device cpu --model-file model.pt --out emb.npz frames/
    python -m r3m_tpu_torch.embed --n-devices 4 --snapshot snap.npz --out emb.npz frames/
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np

from r3m_tpu_torch.utils.misc import pad_batch

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def collect_image_files(inputs: Sequence[str]) -> List[str]:
    """Expand files and directories (recursively) into a sorted list of image files."""
    out: List[str] = []
    for item in inputs:
        if os.path.isdir(item):
            for root, _, names in os.walk(item):
                out.extend(os.path.join(root, n) for n in names
                           if n.lower().endswith(IMAGE_EXTS))
        elif item.lower().endswith(IMAGE_EXTS):
            out.append(item)
        else:
            raise ValueError(f"not an image file or directory: {item}")
    if not out:
        raise ValueError("no image files found")
    return sorted(set(out))  # overlapping inputs must not duplicate rows


def _load_images(paths: Sequence[str], size: int) -> np.ndarray:
    """Decode, Resize(256/224-scaled) and CenterCrop(size): ``[N, 3, size, size]`` uint8.

    The same Pillow calls as the JAX package's loader (the reference example's
    preprocessing, example.py:21-27), so the pixels are equal; the encoder takes them in
    [0, 255].
    """
    from PIL import Image

    resize = max(1, round(size * 256 / 224))
    out = np.empty((len(paths), 3, size, size), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = resize / min(w, h)
            im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                           Image.BILINEAR)
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            im = im.crop((left, top, left + size, top + size))
            out[i] = np.asarray(im, np.uint8).transpose(2, 0, 1)
    return out


def load_encoder(args):
    """The encoder the CLI's arguments name, on ``args.device``, or with ``--n-devices N``
    over a mesh of the first N CUDA devices (N copies of the CPU with ``--device cpu``)."""
    import torch

    import r3m_tpu_torch
    from r3m_tpu_torch.parallel.mesh import make_mesh

    mesh = None
    if args.n_devices:
        cpu = torch.device(args.device).type == "cpu"
        mesh = make_mesh(args.n_devices, devices=[args.device] * args.n_devices if cpu
                         else None)
    kw = {"precision": args.precision, "device": args.device, "mesh": mesh}
    if args.snapshot:
        return r3m_tpu_torch.load_r3m_from_snapshot(args.snapshot, **kw)
    if args.model_file:
        return r3m_tpu_torch.load_r3m_from_files(args.model_file, args.config_file or None,
                                                 **kw)
    return r3m_tpu_torch.load_r3m(args.model, **kw)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="python -m r3m_tpu_torch.embed", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inputs", nargs="+", help="image files and/or directories")
    p.add_argument("--out", required=True, help="output .npz path")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--model", default="resnet50",
                     help="pretrained registry id (resnet18/34/50)")
    src.add_argument("--snapshot", default="", help="native training snapshot (.npz)")
    src.add_argument("--model-file", default="", help="reference torch model.pt / snapshot.pt")
    p.add_argument("--config-file", default="",
                   help="config.yaml next to --model-file (optional)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n-devices", type=int, default=0,
                   help="split each batch over a data-parallel mesh of N cards "
                   "(0 = one device)")
    p.add_argument("--precision", choices=("parity", "fast"), default="parity",
                   help="parity = f32 with TF32 off (the load_r3m law); fast = bf16 serving")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)

    files = collect_image_files(args.inputs)
    enc = load_encoder(args)
    bs = max(1, args.batch)
    if args.n_devices:  # every (padded) batch splits evenly over the mesh
        bs = -(-bs // args.n_devices) * args.n_devices
    chunks = []
    for i in range(0, len(files), bs):
        # streamed from disk a batch at a time; the tail is padded to the batch size, so
        # one input shape serves the whole job, and its padding's rows are dropped
        imgs = _load_images(files[i: i + bs], enc.cfg.image_size)
        chunks.append(enc(pad_batch(imgs, bs))[: imgs.shape[0]].cpu().numpy())
        print(f"embedded {min(i + bs, len(files))}/{len(files)}")
    emb = np.concatenate(chunks).astype(np.float32)

    tmp = args.out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, embeddings=emb, paths=np.asarray(files))
    os.replace(tmp, args.out)
    print(f"wrote {emb.shape[0]} x {emb.shape[1]} embeddings -> {args.out}")
    return args.out


def cli(argv=None) -> int:
    """Console-script entry: ``sys.exit(cli())`` is 0 on success (`main` returns the output
    path, which ``sys.exit`` would take for a failure)."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
