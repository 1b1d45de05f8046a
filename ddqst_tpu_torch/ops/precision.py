"""The TPU's default matmul precision, emulated: bfloat16-input products.

On a TPU, ``ddqst_tpu`` runs every model product at the device's default
precision: one pass of the matrix unit with both operands rounded to
bfloat16 and the sum accumulated in float32. These are flax's ``nn.Dense``
layers (``ddqst_tpu/models/d3pm.py``) and the exact chain's
``einsum("bx,bxy->by")`` (``ddqst_tpu/ops/diffusion.py``), in CE training,
distillation and the held-out CE alike. Only estimator math is raised to
float32 there (``ddqst_tpu/ops/complexlib.py``'s ``f32_matmul``). The port
computes in full float32 with TF32 off (``ddqst_tpu_torch/__init__.py``).

Within :func:`default_matmul_precision` ``("bfloat16")``, named after
``jax.default_matmul_precision``, ``models.d3pm.dense`` (every FiLM-MLP and
``PlainMLP`` layer at float32 compute) and ``ops.diffusion
.chain_distribution``'s product take the functions below, which compute
what the TPU's single pass computes: with r(a) the round to nearest even
of ``a`` to bfloat16, back in float32,

- :func:`linear`: ``r(x) @ r(W)ᵀ + b``; its backward ``gx = r(g) @ r(W)``
  and ``gW = r(g)ᵀ @ r(x)``, as XLA's transposed dots at DEFAULT precision
  compute them, and the bias gradient a float32 sum;
- :func:`chain_product`: ``einsum("bx,bxy->by", r(p), r(T))``; its backward
  ``gp = einsum("by,bxy->bx", r(g), r(T))`` and ``gT = r(p) ⊗ r(g)``.

The product of two bfloat16 values is exact in float32, so these equal
the TPU's pass up to the order of the float32 sum. The backward rounds the products' inputs, not their outputs, so it is written
out here and not taken by autograd through the rounding. Every product itself is a plain
float32 ``torch`` product (TF32 stays off): JAX computes these outside any
Pallas kernel.

The estimators (``ops.mle``, ``ops.pauli``, ``ops.metrics``) never consult
the mode: the reference runs them at float32, and so does the port. The
transformer's products (attention, its tensor-parallel layers) are not
covered, so ``models.transformer`` raises ``ValueError`` within the
context rather than run at float32 unannounced.

The reference for these functions in the tests is the explicit rounding
(float64 products of bfloat16-rounded operands): on the CPU, JAX's own
switch (``jax.default_matmul_precision`` at ``"default"``, ``"bfloat16"``
or ``"tensorfloat32"``) leaves a float32 product exactly as it is at
``"highest"``, so no CPU run of ``ddqst_tpu`` shows the TPU's precision.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "bfloat16")
_mode = "float32"


def current() -> str:
    """The matmul precision the model products run at now."""
    return _mode


def active() -> bool:
    """True within ``default_matmul_precision("bfloat16")``."""
    return _mode == "bfloat16"


@contextlib.contextmanager
def default_matmul_precision(name: str):
    """Within the block, the model products run at ``name``: ``"float32"``
    (the port's default) or ``"bfloat16"`` (the TPU's default, emulated).
    Raises ``ValueError`` for another name; the previous mode comes back on
    exit, also when an exception leaves the block."""
    global _mode
    if name not in MODES:
        raise ValueError(f"unknown matmul precision {name!r}; options: "
                         f"{list(MODES)}")
    prev, _mode = _mode, name
    try:
        yield
    finally:
        _mode = prev


def refuse(what: str) -> None:
    """Raise ``ValueError`` when the mode is not float32: ``what``'s
    products are not covered by the emulation."""
    if _mode != "float32":
        raise ValueError(f"matmul precision {_mode!r} does not cover {what}'s "
                         "products; run it at 'float32'")


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to nearest even in bfloat16, returned in float32."""
    return a.to(torch.bfloat16).to(torch.float32)


class _Linear(torch.autograd.Function):
    """``r(x) @ r(W)ᵀ + b`` with the bf16-pass backward."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        return torch.nn.functional.linear(xr, wr, bias)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_bf16(g)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = gr @ wr
        if ctx.needs_input_grad[1]:
            gw = (gr.reshape(-1, gr.shape[-1]).T
                  @ xr.reshape(-1, xr.shape[-1]))
        if ctx.needs_input_grad[2]:
            gb = g.reshape(-1, g.shape[-1]).sum(0)
        return gx, gw, gb


class _ChainProduct(torch.autograd.Function):
    """``einsum("bx,bxy->by", r(p), r(T))`` with the bf16-pass backward."""

    @staticmethod
    def forward(ctx, dist, trans):
        dr, tr = round_bf16(dist), round_bf16(trans)
        ctx.save_for_backward(dr, tr)
        return torch.einsum("bx,bxy->by", dr, tr)

    @staticmethod
    def backward(ctx, g):
        dr, tr = ctx.saved_tensors
        gr = round_bf16(g)
        gd = gt = None
        if ctx.needs_input_grad[0]:
            gd = torch.einsum("by,bxy->bx", gr, tr)
        if ctx.needs_input_grad[1]:
            gt = torch.einsum("bx,by->bxy", dr, gr)
        return gd, gt


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` as one bf16-input pass (float32
    operands, float32 result)."""
    return _Linear.apply(x, weight, bias)


def chain_product(dist: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``einsum("bx,bxy->by", dist, trans)`` as one bf16-input pass."""
    return _ChainProduct.apply(dist, trans)
