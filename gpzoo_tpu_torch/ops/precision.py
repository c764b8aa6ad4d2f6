"""The JAX package's matmul precision strings as Hopper math modes.

The JAX package names the precision of a product with the strings of
``jax.default_matmul_precision``; here each string takes one mode of the
card, from :data:`MODES`, the only place a mode is chosen:

    string     JAX alias                     H100 mode
    "highest"  float32                       IEEE float32, TF32 off
    "high"     bfloat16_3x / tensorfloat32   IEEE float32 (TF32 measured
                                             off the mark, below)
    "default"  bfloat16                      bf16 operands, float32
                                             accumulation, float32 result

The modes a product can take are "ieee", "tf32" (through cuBLAS) and
"bf16". "high" started at TF32, its JAX alias on a GPU, and was moved to
IEEE by the MGGP benchmark leg's A/B on the H100 (``chip_smoke.py``
[mggp]): with chol_precision alone at "high" in TF32, the held-out
deviance after 56 steps moved 1.7e-2 (relative) from the IEEE run's,
against a limit of 1e-3; "default" alone in bf16 moved it 9.3e-6.

A governed product is computed by :func:`mm` (or differentiably by
:func:`matmul`), which takes its string as an argument and enters the
mode for that product alone, so no caller's context can override it and
a product's backward, which runs after the caller's code has returned,
enters it again. The mode in force is :func:`in_force`. No mode changes a
product of float64 tensors (JAX's matmul precision does not either) or of
CPU tensors; the mode is entered there all the same.

The TF32 switch of cuBLAS is process-wide: a mode sets it for one product
and restores it after, on an exception too.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

#: the matmul precision strings the blockwise loss takes
PRECISIONS = ("default", "high", "highest")

#: string → Hopper math mode: "ieee" float32, "tf32" through cuBLAS, or
#: "bf16" operands with float32 accumulation and a float32 result
MODES = {"highest": "ieee", "high": "ieee", "default": "bf16"}

# per thread (autograd may run a backward on a thread of its own): the
# (precision, role) of the products being computed, innermost last; role is
# "forward" or "backward"
_LOCAL = threading.local()


def _stack():
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def check(precision, knob="precision"):
    """``precision`` if it is one of :data:`PRECISIONS`, else ValueError."""
    if precision not in PRECISIONS:
        raise ValueError(f"{knob}={precision!r}: expected one of {PRECISIONS}")
    return precision


def in_force():
    """(precision, role) of the innermost product being computed, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def _entered(precision, role):
    stack = _stack()
    stack.append((check(precision), role))
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def _cublas(tf32):
    """cuBLAS's TF32 switch set to ``tf32``, float32 accumulation of bf16
    products required, both restored on exit."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = tf32
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved


@functools.cache
def bf16_path():
    """How "default" gets a float32 result from bf16 operands on the card:
    "out_dtype" where ``torch.bmm`` returns float32 from bf16 operands,
    else "rounded" (the bf16 result, cast back to float32)."""
    a = torch.ones((1, 2, 2), dtype=torch.bfloat16, device="cuda")
    try:
        out = torch.bmm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return "rounded"
    return "out_dtype" if out.dtype == torch.float32 else "rounded"


def _bf16(a, b):
    """a @ b from bf16 operands with float32 accumulation, as float32."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a16 = a.to(torch.bfloat16).expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b16 = b.to(torch.bfloat16).expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    if bf16_path() == "out_dtype":
        out = torch.bmm(a16, b16, out_dtype=torch.float32)
    else:
        out = torch.bmm(a16, b16).float()
    return out.reshape(batch + out.shape[-2:])


def _product(a, b):
    """a @ b in the mode in force."""
    mode = MODES[in_force()[0]]
    if a.device.type != "cuda" or a.dtype != torch.float32 or b.dtype != torch.float32:
        return torch.matmul(a, b)
    if mode != "ieee" and torch.cuda.get_device_capability(a.device) < (8, 0):
        raise RuntimeError(f"matmul mode {mode!r} needs a card of compute "
                           "capability 8.0 or later")
    with _cublas(mode == "tf32"):
        return _bf16(a, b) if mode == "bf16" else torch.matmul(a, b)


def mm(a, b, precision, role="forward"):
    """a @ b (at least 2-D each, broadcast batch) in ``precision``'s mode;
    ``role`` says whether it belongs to a forward or a backward."""
    with _entered(precision, role):
        return _product(a, b)


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision, keep):
        ctx.precision = precision
        ctx.save_for_backward(a, b)
        if keep is None:
            return mm(a, b, precision)
        return keep(lambda: mm(a, b, precision))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = mm(g, b.mT, ctx.precision, "backward").sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = mm(a.mT, g, ctx.precision, "backward").sum_to_size(b.shape)
        return ga, gb, None, None


def matmul(a, b, precision, keep=None):
    """Differentiable a @ b (at least 2-D each, broadcast batch) whose
    forward and backward products run in ``precision``'s mode. ``keep``,
    where given, is called with the function that computes the product and
    returns the product (the remat policy's record of the products it
    keeps for the recompute, ``train.policy.Kept``)."""
    return _Product.apply(a, b, check(precision), keep)
