"""The arithmetic the plain reference computes in.

`Precision("float32")` is the reference itself: every product in float32,
TF32 off. `Precision("float8")` is the control that the correctness limits
are set against: the nearest precision below the configurations' bfloat16,
computed by rounding every operand of a product (convolution, linear layer,
attention matmul) to float8 e4m3 in the forward and every gradient that
reaches a product's output to float8 e5m2 in the backward, as fp8 training
does. Sums, normalisations and the optimizer stay float32 in both.
`Precision("bfloat16")` rounds the same places to bfloat16: a witness of
what the configuration's own precision does to a number.
"""

from __future__ import annotations

import torch

FORMATS = ("float32", "bfloat16", "float8")
# (operand format in the forward, gradient format in the backward)
ROUNDING = {"bfloat16": (torch.bfloat16, torch.bfloat16), "float8": (torch.float8_e4m3fn, torch.float8_e5m2)}


class _RoundGrad(torch.autograd.Function):
    """Identity in the forward; the gradient rounded to `fmt` in the backward."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


class _RoundOperand(torch.autograd.Function):
    """The operand rounded to `fmt` in the forward; the gradient passes."""

    @staticmethod
    def forward(ctx, x, fmt):
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """`x` rounded to `fmt` (saturating at its largest finite value) and back."""
    big = torch.finfo(fmt).max
    return x.clamp(-big, big).to(fmt).to(x.dtype)


class Precision:
    """Where the reference rounds: `operand` before a product, `output` after it."""

    def __init__(self, name: str = "float32"):
        if name not in FORMATS:
            raise ValueError(f"precision {name!r} not in {FORMATS}")
        self.name = name
        self.formats = ROUNDING.get(name)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundOperand.apply(x, self.formats[0]) if self.formats else x

    def output(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(x, self.formats[1]) if self.formats and x.requires_grad else x
