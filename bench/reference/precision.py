"""The precision a reference computation runs its products in.

``Precision("stated")`` is the configuration's own: bfloat16 products of
bfloat16 operands (float32 accumulation, bfloat16 result) and float32
products with TF32 off.  ``Precision("control")`` is the step below that a
faster implementation might be tempted to take: bfloat16 operands rounded
to float8 e4m3 (one scale per tensor), and under autograd the incoming
gradient to float8 e5m2, as an fp8 training step rounds them; float32
operands rounded to TF32's 10-bit mantissa.  The roundings are emulated on
the operands, so the control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest even at 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    drop = 13
    bias = (1 << (drop - 1)) - 1 + ((i >> drop) & 1)
    return ((i + bias) & ~((1 << drop) - 1)).view(F32)


FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8_round(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` through float8 ``fmt`` at one scale per tensor, back in its
    own dtype."""
    amax = float(x.abs().max().float())
    if amax == 0.0:
        return x
    scale = FP8[fmt] / amax
    q = (x.to(F32) * scale).to(fmt).to(F32) / scale
    return q.to(x.dtype)


def _summed_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    return g


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on e4m3 operands whose backward takes the incoming
    gradient in e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        gb = torch.matmul(aq.transpose(-1, -2), gq)
        return _summed_to(ga, ctx.shapes[0]), _summed_to(gb, ctx.shapes[1])


class Precision:
    def __init__(self, kind: str = "stated"):
        assert kind in ("stated", "control"), kind
        self.kind = kind

    def lower(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` at this precision; under autograd the rounding passes the
        gradient straight through."""
        if self.kind == "stated":
            return t
        d = t.detach()
        q = tf32_round(d) if t.dtype == F32 else fp8_round(d)
        return t + (q - d) if t.requires_grad else q

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched as ``torch.matmul``) at this precision."""
        if (self.kind == "control" and a.dtype != F32
                and (a.requires_grad or b.requires_grad)):
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(self.lower(a), self.lower(b))
