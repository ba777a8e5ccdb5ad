"""The serving window of `serve_closed_loop` over DINOv2 with registers: the same client,
requests, window and sample, with the backbone's weights drawn by the specs of
`port_bench.reference.dinov2` and the sample embedded by its forward. The encoder is
``R3MEncoder`` with ``size`` set to the configuration's backbone name, built from the drawn
HF-layout state dict.

A program without the backbone fails at once: the first thing set-up does is import it.
"""

from __future__ import annotations

import torch

from port_bench import harness, weights
from port_bench.reference import dinov2 as ref
from port_bench.reference.precision import Arith

closed_loop = harness.load_module("drivers", "serve_closed_loop")


class Cell(closed_loop.Cell):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault=None):
        import r3m_tpu_torch.models.dinov2  # noqa: F401

        super().__init__(cfg, mix, seed, device, fault)

    def _weights(self):
        return weights.make_tensors(ref.dinov2_specs(self.cfg["backbone"]),
                                    self.seeds["weights"], self.device)

    def reference(self, arith: Arith, indices) -> torch.Tensor:
        """The reference's embeddings of the requests `indices`, a block at a time."""
        params = self._weights()
        frames = torch.cat([self.frames[self.order[i % len(self.order)]] for i in indices])
        block = closed_loop.BLOCK
        out = [ref.serve(self.cfg, params, frames[s:s + block].to(self.device), arith).cpu()
               for s in range(0, len(frames), block)]
        return torch.cat(out)
