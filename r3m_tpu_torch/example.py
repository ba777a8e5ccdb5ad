"""Embed one image with the pretrained ResNet-50 R3M: the port's counterpart of the repo's
root ``example.py`` (the reference's ``r3m/example.py``).

    python -m r3m_tpu_torch.example                # on the CUDA card
    python -m r3m_tpu_torch.example --device cpu   # the kernels' plain versions

It loads ``load_r3m("resnet50")``, encodes one random 500x500 uint8 image and prints the
``[1, 2048]`` embedding shape. The encoder's forward is the serving path: preprocess
(Resize(256), CenterCrop(224), normalize) on the device, BatchNorm folded into the
convolutions, the folded ResNet-50 with its stem max-pool through the hand-written CUDA
kernel (``r3m_tpu_torch/csrc/maxpool.cu``). Where the pretrained weights are neither
cached under ``$R3M_HOME`` nor downloadable (an offline host), it says so and serves a
ResNet-50 drawn from seed 0 instead. The device is the one asked for: without a card a
CUDA request raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from r3m_tpu_torch import R3MConfig, R3MEncoder, load_r3m, r3m_init
from r3m_tpu_torch.models.r3m import resolve_device


def random_init_encoder(device, precision: str = "parity") -> R3MEncoder:
    """A ResNet-50 `R3MEncoder` drawn from seed 0, without its language head."""
    cfg = R3MConfig(size=50, langweight=0)
    return R3MEncoder(cfg, r3m_init(cfg, seed=0).convnet.state_dict(), precision=precision,
                      device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="the device to serve on (default cuda; cpu runs without a card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # without a card a CUDA request raises here
    try:
        r3m = load_r3m("resnet50", device=device)
        print("loaded pretrained resnet50")
    except RuntimeError as e:  # an offline host without a populated cache
        print(f"pretrained weights unavailable ({e}); using random init")
        r3m = random_init_encoder(device)
    r3m.eval()

    image = np.random.randint(0, 255, (500, 500, 3), dtype=np.uint8)
    # NCHW in [0, 255], like the reference's `r3m(preprocessed_image * 255.0)`
    embedding = r3m(image.transpose(2, 0, 1)[None])
    print(list(embedding.shape))  # [1, 2048]
    return 0


if __name__ == "__main__":
    sys.exit(main())
