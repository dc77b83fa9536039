"""Precisions of the reference's products.  ``F32``: float32, the
reference.  ``FP8``: the control, computed in the next precision below
the configuration's bfloat16, the step that would tempt a later change:
both operands of every product of activations and weights rounded to
float8 (e4m3), weights with a scale for each output column, activations
with one for each row, and the sums in float32.  The rounding passes the
gradient unchanged (straight through)."""
from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice, the amax taken over
    ``dim``; float32 out, its gradient straight through."""
    v = x.detach()
    s = torch.clamp(v.abs().amax(dim=dim, keepdim=True), min=1e-12) / FP8_MAX
    r = (v / s).to(torch.float8_e4m3fn).to(v.dtype) * s
    return x + (r - v)


class Precision:
    """``mm(x, w)``: the product of activations x (..., k) and a weight
    (k, n); ``w`` and ``a`` round a weight or an activation that enters a
    product elsewhere."""

    def __init__(self, fp8_products: bool):
        self.low = fp8_products

    def w(self, w):
        return fp8(w, tuple(range(w.ndim - 1))) if self.low and w.ndim > 1 \
            else w

    def a(self, x):
        return fp8(x, -1) if self.low else x

    def mm(self, x, w):
        return self.a(x) @ self.w(w)


F32 = Precision(False)
FP8 = Precision(True)
