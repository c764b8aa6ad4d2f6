"""The blockwise loss's dispatch policy: projection form, precision knobs and
remat (port of ``gpzoo_tpu/train/policy.py``).

:func:`resolve_policy` takes the same arguments and applies the same auto
rules as the JAX package's; :class:`FastPathPolicy` holds what it resolves.
Each precision string is a Hopper math mode of
:data:`gpzoo_tpu_torch.ops.precision.MODES`.

| knob             | auto rule (None)                                    |
|------------------|-----------------------------------------------------|
| grad_precision   | "default" if jitter ≥ 1e-2 else "highest"           |
| proj_precision   | "high" if jitter ≥ 1e-2 else "highest"              |
| chol_precision   | "high" if jitter ≥ 1e-2 and the W-form, else "highest" |
| bwd_blocked      | grad_precision == "highest"                         |
| stable_projection| jitter < 1e-2 (unwhitened, not the W-form); always whitened |
| remat            | the caller's: True, False (or None), "save_proj", "save_proj_kzx" |

The W-form is the unwhitened factored loss over a per-factor (L, M, M)
prior Cholesky. ``grad_precision`` governs the five products of the
Cholesky-and-inverse backward, ``proj_precision`` the chunk projection
a = W·Kzx and C = W·Lu (forward and backward), ``chol_precision`` the
products that build W = Lzz⁻¹ and K⁻¹ on every factored branch. The mean's
products stay at "highest".
"""

from __future__ import annotations

import dataclasses
import functools

from torch.utils.checkpoint import checkpoint

from gpzoo_tpu_torch.ops.precision import PRECISIONS, check

REMAT_POLICIES = (True, False, "save_proj", "save_proj_kzx")

#: jitter at or above this is well conditioned for the reduced-precision gates
WELL_JITTERED = 1e-2

__all__ = ["FastPathPolicy", "Kept", "PRECISIONS", "REMAT_POLICIES",
           "WELL_JITTERED", "resolve_policy"]


class Kept:
    """The products a chunk keeps from its first run for the recompute of its
    backward. Called with the function that computes a product: in the first
    run it computes it and keeps the value; in the recompute it hands the
    kept values back in the order they were made, computing none of them."""

    def __init__(self):
        self._values = []
        self._runs = 0
        self._next = 0

    def run(self, fn, *args, **kwargs):
        self._runs += 1
        self._next = 0
        return fn(*args, **kwargs)

    def __call__(self, compute):
        if self._runs <= 1:
            out = compute()
            self._values.append(out.detach())
            return out
        i, self._next = self._next, self._next + 1
        if i < len(self._values) and self._values[i] is not None:
            out, self._values[i] = self._values[i], None
            return out
        return compute()  # a second backward: nothing is kept any more


@dataclasses.dataclass(frozen=True)
class FastPathPolicy:
    """Resolved dispatch decisions of one call of the blockwise loss."""

    w_form: bool
    stable_projection: bool
    grad_precision: str
    proj_precision: str
    bwd_blocked: bool
    remat: object  # True | False | "save_proj" | "save_proj_kzx"
    chol_precision: str = "highest"

    def wrap_remat(self, chunk_fn, gram_fn=None):
        """``chunk_fn(*args, kzx=None, keep=None)``, the per-chunk body, under
        the remat policy. False runs it as it is: its backward keeps all it
        needs. True recomputes all of it in the backward
        (``torch.utils.checkpoint``). "save_proj" recomputes it too, but for
        the products it makes through ``keep`` (the chunk's projection a),
        which are kept from the first run. "save_proj_kzx" also keeps the
        chunk's Gram columns: ``gram_fn(*args)`` runs before the recomputed
        region and its result is passed as ``kzx``."""
        if not self.remat:
            return chunk_fn

        def run(*args):
            kwargs = {}
            if self.remat in ("save_proj", "save_proj_kzx"):
                kept = Kept()
                kwargs["keep"] = kept
                body = functools.partial(kept.run, chunk_fn)
            else:
                body = chunk_fn
            if self.remat == "save_proj_kzx" and gram_fn is not None:
                kwargs["kzx"] = gram_fn(*args)
            return checkpoint(functools.partial(body, **kwargs), *args,
                              use_reentrant=False)
        return run


def resolve_policy(jitter, *, whitened, factored, per_factor_chol,
                   stable_projection=None, grad_precision=None,
                   proj_precision=None, remat=True, chol_precision=None):
    """Resolve the blockwise loss's knobs, as the JAX package does.

    ``per_factor_chol``: the prior Cholesky after the shared-kernel collapse
    is (L, M, M), which selects the W-form projection. A knob left None takes
    its auto rule (module table); a value given passes through. A remat or
    precision value outside REMAT_POLICIES (or None) or PRECISIONS raises
    ValueError."""
    if remat is None:
        remat = False
    if not (isinstance(remat, bool) or remat in REMAT_POLICIES):
        raise ValueError(f"remat={remat!r}: expected True, False, 'save_proj' or "
                         "'save_proj_kzx'")
    well_jittered = jitter >= WELL_JITTERED
    w_form = bool(factored and not whitened and per_factor_chol)
    if grad_precision is None:
        grad_precision = "default" if well_jittered else "highest"
    if proj_precision is None:
        proj_precision = "high" if well_jittered else "highest"
    if chol_precision is None:
        chol_precision = "high" if well_jittered and w_form else "highest"
    stable = bool(whitened or (not well_jittered if stable_projection is None
                               else stable_projection))
    for knob, val in (("grad_precision", grad_precision),
                      ("proj_precision", proj_precision),
                      ("chol_precision", chol_precision)):
        check(val, knob)
    return FastPathPolicy(w_form=w_form, stable_projection=stable,
                          grad_precision=grad_precision,
                          proj_precision=proj_precision,
                          bwd_blocked=grad_precision == "highest", remat=remat,
                          chol_precision=chol_precision)
