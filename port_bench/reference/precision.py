"""The arithmetic of the plain reference: every product (convolution, linear layer,
matmul) goes through one `Arith`, which fixes its precision.

- ``"f32"``: true float32, TF32 off for cuBLAS and cuDNN. This is the reference.
- ``"tf32"``: float32 with TF32 on: the control of a configuration that states f32.
- ``"fp8"``: every product's operands and its result held in float8 e4m3, each tensor
  with a scale of its own (its largest magnitude maps to 448), the products accumulated
  in float32: the control of a configuration that states bfloat16.
- ``"bf16"``: the same with bfloat16 in place of float8: a witness of what bfloat16
  arithmetic alone does to the numbers compared.

The rounding passes the gradient straight through, so a step of the reference runs in
each mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8", "bf16")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


_ROUND = {"fp8": _RoundFp8.apply, "bf16": _RoundBf16.apply}


class Arith:
    """Products in one precision mode (`MODES`); `scope` sets the library flags."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        rounding = _ROUND.get(self.mode)
        return rounding(x) if rounding else x

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, w, b=None, stride: int = 1, padding: int = 0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))

    @contextlib.contextmanager
    def scope(self):
        """TF32 on only in ``"tf32"``; the caller's settings come back after."""
        saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
        tf32 = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = saved[0]
            torch.set_float32_matmul_precision(saved[1])
