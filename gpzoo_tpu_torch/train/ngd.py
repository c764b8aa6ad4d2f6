"""Natural-gradient VI for q(u) (port of ``gpzoo_tpu/train/ngd.py``).

The natural parameters θ1 = S⁻¹m, θ2 = −½S⁻¹ of each factor's q(u) =
N(m, S) move along the ELBO's gradient with respect to the expectation
parameters (m, S + mmᵀ):

    P′ = P + 2ρ g_S,   θ1′ = Pm − ρ(g_m − 2 g_S m),   m′ = P′⁻¹θ1′,

with g_m, g_S the gradients of the negative ELBO. One step at ρ = 1 is the
exact posterior of a conjugate Gaussian model. The head's other leaves (W,
V, an NB dispersion) take Adam updates (:class:`HeadAdam`, optax.adam's
arithmetic) from the same loss evaluation.

The state carries the precision P = S⁻¹ and its Cholesky factor; a step
rebuilds S = P⁻¹ from the factor by the blocked ``tri_inverse``, evaluates
the ELBO in (m, S) without its −½ log|S| term (that term's value comes from
the carried factor and its S-gradient, −½P, is added outside autograd), and
makes one (L, M, M) Cholesky of P′.

Scope, as in the JAX package: NSF-family heads (Poisson or negative
binomial) over an unwhitened SVGP with per-factor (L, M) μ and (L, M, M)
q(u) factor and frozen Z and kernel, on the precomputed projection: the
north-star configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpzoo_tpu_torch.bijectors import (lower_cholesky, lower_cholesky_inverse,
                                       softplus)
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.linalg import spd_inverse_from_cholesky, tri_inverse
from gpzoo_tpu_torch.train.fast import _count_py


def _is_qu_or_geometry(path):
    """The leaves the natural update owns (μ, the q(u) factor) or that stay
    frozen (Z, the kernel): everything else takes the head's Adam."""
    return (path.endswith(".mu") or path.endswith(".Lu_raw")
            or path.endswith(".Z") or ".kernel." in path)


@dataclasses.dataclass(frozen=True)
class HeadAdam:
    """Adam on the head's leaves with optax.adam's arithmetic (ε outside
    the root, no ε inside it), applied under the step's skip mask: a skipped
    step leaves the leaves, both moments and the count as they were, with
    no host sync. Its state, from :meth:`init`, is {"count": int32 scalar,
    "mu": {path: first moment}, "nu": {path: second moment}}."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        first = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update_(self, params, grads, opt_state, ok):
        """Apply one update in place where ``ok`` (a device bool scalar)."""
        count = opt_state["count"] + 1
        opt_state["count"] = torch.where(ok, count, opt_state["count"])
        for path, p in params.items():
            g = grads[path]
            mu = (1 - self.b1) * g + self.b1 * opt_state["mu"][path]
            nu = (1 - self.b2) * torch.square(g) + self.b2 * opt_state["nu"][path]
            mu_hat = mu / (1 - self.b1 ** count.double()).to(mu.dtype)
            nu_hat = nu / (1 - self.b2 ** count.double()).to(nu.dtype)
            new = p - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
            p.copy_(torch.where(ok, new, p))
            opt_state["mu"][path] = torch.where(ok, mu, opt_state["mu"][path])
            opt_state["nu"][path] = torch.where(ok, nu, opt_state["nu"][path])


@dataclasses.dataclass
class NGDTrainState:
    """The state of the NGD(q(u)) + Adam(head) optimizer.

    ``model.prior.mu`` holds the current variational mean m (kept in step,
    so the posterior paths read it from the model); ``model.prior.Lu_raw``
    is not updated while training: :func:`ngd_to_model` writes the
    covariance back. ``step`` counts steps on the host (the ρ ramp reads
    it); ``generator`` is the one the step draws idx and eps from."""

    model: torch.nn.Module
    prec: torch.Tensor       # (L, M, M) P = S⁻¹
    prec_chol: torch.Tensor  # chol(P), kept in step with prec
    opt_state: dict          # HeadAdam's state for the head's leaves
    generator: torch.Generator
    step: int = 0

    def advance(self, step_fn, args):
        """One step ``step_fn(self, *args)``, which counts itself."""
        return step_fn(self, *args)

    def state_dict(self):
        return {"model": self.model.state_dict(), "prec": self.prec,
                "prec_chol": self.prec_chol, "opt_state": self.opt_state,
                "generator": self.generator.get_state(), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.prec.copy_(state["prec"])
        self.prec_chol.copy_(state["prec_chol"])
        self.opt_state["count"].copy_(state["opt_state"]["count"])
        for moment in ("mu", "nu"):
            for path, t in self.opt_state[moment].items():
                t.copy_(state["opt_state"][moment][path])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


@torch.no_grad()
def _init_precision(gp):
    lu = lower_cholesky(gp.Lu_raw)
    lu = lu if lu.ndim == 3 else lu[None]
    w = tri_inverse(lu)  # Lu⁻¹
    prec = w.mT @ w  # Lu⁻ᵀ Lu⁻¹ = S⁻¹
    return prec, torch.linalg.cholesky(prec)


def _head_params(model):
    return {path: p for path, p in model.named_parameters()
            if p.is_floating_point() and not _is_qu_or_geometry(path)}


def ngd_create(model, optimizer, generator):
    """(:class:`NGDTrainState`, ``optimizer``) for an NSF-family model whose
    prior carries per-factor (L, M) mu and (L, M, M) Lu_raw: NSF and NBNSF
    (the NB dispersion trains with the head). ``optimizer`` is a
    :class:`HeadAdam`; it updates every parameter but μ, the q(u) factor,
    Z and the kernel, whatever their ``requires_grad`` (which it sets, with
    μ's). ``generator`` is the state's own, kept by reference."""
    gp = getattr(model, "prior", None)
    if gp is None or not hasattr(gp, "Lu_raw"):
        raise ValueError(
            "NGD needs an NSF-family model whose .prior is an SVGP-style "
            "posterior with per-factor (L, M) mu and (L, M, M) Lu_raw; "
            f"got {type(model).__name__}. Hybrid heads (sf/cf halves — "
            "the (m, S) ELBO has no mean-field term) and mean-field "
            "priors keep the Adam paths.")
    if gp.mu.ndim != 2 or gp.Lu_raw.ndim != 3:
        raise ValueError(
            "NGD needs the per-factor layout: mu (L, M), Lu_raw (L, M, M); "
            f"got mu {tuple(gp.mu.shape)}, Lu_raw {tuple(gp.Lu_raw.shape)}")
    head = _head_params(model)
    for p in (gp.mu, *head.values()):
        p.requires_grad_(True)
    prec, prec_chol = _init_precision(gp)
    state = NGDTrainState(model=model, prec=prec, prec_chol=prec_chol,
                          opt_state=optimizer.init(head), generator=generator)
    return state, optimizer


def _ngd_negative_elbo_nologdet(model, s, proj, y, idx, eps,
                                unnormalized=True, y_transposed=False):
    """−ELBO in (m, S) from a frozen unwhitened projection, without the
    −½ log|S| term of the KL (the step adds its value from the carried
    Cholesky factor and its S-gradient −½P by hand). idx (B,), eps
    (E, L, B) standard-normal draws, counts y (D, N), or (N, D) with
    ``y_transposed``. Equals ``nsf_negative_elbo_precomputed`` at
    S = LuLuᵀ once log|Lu| is subtracted."""
    gp = model.prior
    mu_l = gp.mu  # (L, M)
    at = proj.proj_t[idx].T  # (M, B)
    mean = mu_l @ at
    sa = s @ at  # (L, M, B)
    c2 = torch.sum(at * sa, dim=-2)  # ãᵀ S ã
    base = proj.kxx - proj.a2[idx]
    cov = clip_min(base + c2, gp.var_floor)
    mean, cov = torch.broadcast_tensors(mean, cov)
    f = mean + torch.sqrt(cov) * eps
    rate = softplus(model.V_raw[idx]) * (softplus(model.W_raw) @ torch.exp(f))
    py = _count_py(model, rate)
    yb = y[idx].T if y_transposed else y[:, idx]
    lp = py.unnormalized_log_prob(yb) if unnormalized else py.log_prob(yb)
    ll = torch.sum(torch.mean(lp, dim=0))

    m_dim = mu_l.shape[-1]
    trace = torch.einsum("mk,lmk->l", proj.k_inv, s)
    maha = torch.einsum("lm,mk,lk->l", mu_l, proj.k_inv, mu_l)
    kl_nologdet = torch.sum(0.5 * (trace + maha - m_dim) + proj.logdet_lzz)
    return -(ll - kl_nologdet)


def _cholesky_or_nan(p):
    """chol(P) per factor, NaN over every factor that is not positive
    definite. ``torch.linalg.cholesky_ex`` leaves a finite partial factor
    there (info > 0); ``jnp.linalg.cholesky`` returns NaN, which is what
    the PD guard tests."""
    chol, info = torch.linalg.cholesky_ex(p)
    return torch.where((info != 0)[:, None, None], torch.nan, chol)


def natural_update(m, prec, g_m, g_s, rho):
    """One NGVI step on N(m, S = P⁻¹) from the descent gradients (g_m, g_s)
    of the negative ELBO: (m′, P′, chol(P′)), batched over factors:

        P′ = P + 2ρ g_s,  θ1′ = Pm − ρ(g_m − 2 g_s m),  m′ = P′⁻¹θ1′

    (two triangular solves against chol(P′)). A factor whose P′ is not
    positive definite gets a NaN factor and mean, as in JAX."""
    g_s = 0.5 * (g_s + g_s.mT)
    prec_new = prec + 2.0 * rho * g_s
    prec_new = 0.5 * (prec_new + prec_new.mT)
    theta1 = torch.einsum("lmk,lk->lm", prec, m)
    gsm = torch.einsum("lmk,lk->lm", g_s, m)
    theta1_new = theta1 - rho * (g_m - 2.0 * gsm)
    chol_new = _cholesky_or_nan(prec_new)
    m_new = torch.cholesky_solve(theta1_new[..., None], chol_new)[..., 0]
    return m_new, prec_new, chol_new


def _pd_guard(m, prec, prec_chol, g_m, g_s, rho):
    """:func:`natural_update_guarded` with its (L,) rejection mask."""
    m_new, prec_new, chol_new = natural_update(m, prec, g_m, g_s, rho)
    bad = ~torch.isfinite(chol_new).all(dim=-1).all(dim=-1)
    # an overflowed but finite P′ can still give a non-finite mean
    bad |= ~torch.isfinite(m_new).all(dim=-1)
    m_new = torch.where(bad[:, None], m, m_new)
    prec_new = torch.where(bad[:, None, None], prec, prec_new)
    chol_new = torch.where(bad[:, None, None], prec_chol, chol_new)
    return m_new, prec_new, chol_new, bad


def natural_update_guarded(m, prec, prec_chol, g_m, g_s, rho):
    """:func:`natural_update` with the PD guard: a factor whose P′ leaves
    the PD cone (non-finite Cholesky factor) or whose new mean is not
    finite keeps (m, P, chol P) this step; the others move. Returns
    (m′, P′, chol(P′), the count of rejected factors as a device scalar)."""
    m_new, prec_new, chol_new, bad = _pd_guard(m, prec, prec_chol, g_m, g_s, rho)
    return m_new, prec_new, chol_new, torch.sum(bad)


def _ramp(step, ramp_steps):
    """0.01 + 0.99·min(1, (step + 1)/ramp_steps) as the JAX step computes
    it: in float32 (its step count is int32), the division compiled to a
    product with float32 1/ramp_steps and the rest to one fused
    multiply-add (exact in float64 before its float32 rounding)."""
    f32 = np.float32
    frac = min(f32(1.0), f32(step + 1) * (f32(1.0) / f32(ramp_steps)))
    return float(f32(np.float64(f32(0.99)) * np.float64(frac) + np.float64(f32(0.01))))


def _ngd_loss_and_grads(state, proj, y, idx, eps, unnormalized=True,
                        y_transposed=False):
    """The step's negative ELBO with its −½log|S| term (a detached scalar)
    and its descent gradients: g_m (L, M), g_S (L, M, M) with −½P added by
    hand, and {path: gradient} of the head's leaves. S is rebuilt from the
    carried Cholesky factor of P."""
    model = state.model
    head = _head_params(model)
    with torch.no_grad():
        s = spd_inverse_from_cholesky(state.prec_chol, block=512)
        s = 0.5 * (s + s.mT)
    s.requires_grad_(True)
    loss = _ngd_negative_elbo_nologdet(model, s, proj, y, idx, eps,
                                       unnormalized=unnormalized,
                                       y_transposed=y_transposed)
    g_m, g_s, *g_head = torch.autograd.grad(loss, [model.prior.mu, s, *head.values()])
    with torch.no_grad():
        # the KL's −½ log|S| = +Σ log diag chol(P), and its S-gradient
        # −½S⁻¹ = −½P, on the negative ELBO
        diag = state.prec_chol.diagonal(dim1=-2, dim2=-1)
        loss = loss.detach() + torch.sum(torch.log(diag))
        g_s = g_s - 0.5 * state.prec
    return loss, g_m, g_s, dict(zip(head, g_head))


@torch.no_grad()
def ngd_step(state, optimizer, proj, y, idx, eps, nat_lr, ramp_steps=0,
             max_f=60.0, unnormalized=True, y_transposed=False):
    """One NGD(q(u)) + Adam(head) step of ``state`` in place on the given
    minibatch idx (B,) and draws eps (E, L, B): the step of
    :func:`make_ngd_train_step` without its draws. Returns (the loss, a
    detached device scalar, and the count of factors whose natural update
    the guards rejected).

    The guards, in the JAX package's order: ρ ramps as nat_lr·(0.01 +
    0.99·min(1, (step + 1)/ramp_steps)); a factor whose P′ is not positive
    definite keeps (m, P); with ``max_f``, so does a factor whose new mean
    function |m′ᵀã| exceeds ``max_f`` anywhere on this minibatch (it would
    overflow exp in float32 on a later step); a non-finite loss skips the
    whole step (model, Adam moments and count, P, chol P), and only the
    step count and the generator advance."""
    with torch.enable_grad():
        loss, g_m, g_s, g_head = _ngd_loss_and_grads(
            state, proj, y, idx, eps, unnormalized, y_transposed)
    mu = state.model.prior.mu
    rho = nat_lr * _ramp(state.step, ramp_steps) if ramp_steps else nat_lr
    m_new, prec_new, chol_new, bad = _pd_guard(
        mu, state.prec, state.prec_chol, g_m, g_s, rho)
    if max_f is not None:
        f_new = m_new @ proj.proj_t[idx].T  # the loss's gather
        bad_f = ~(torch.amax(torch.abs(f_new), dim=-1) <= max_f)  # NaN too
        bad = bad | bad_f
        m_new = torch.where(bad_f[:, None], mu, m_new)
        prec_new = torch.where(bad_f[:, None, None], state.prec, prec_new)
        chol_new = torch.where(bad_f[:, None, None], state.prec_chol, chol_new)

    ok = torch.isfinite(loss)
    optimizer.update_(_head_params(state.model), g_head, state.opt_state, ok)
    mu.copy_(torch.where(ok, m_new, mu))
    state.prec = torch.where(ok, prec_new, state.prec)
    state.prec_chol = torch.where(ok, chol_new, state.prec_chol)
    state.step += 1
    return loss, torch.sum(bad)


def make_ngd_train_step(optimizer, num_points, batch_size, nat_lr, ramp_steps=0,
                        E=1, loss_kwargs=None, mesh=None, state_shardings=None,
                        max_f=60.0):
    """Build ``step(state, proj, y) → loss``: NGD on (μ, q(u) covariance)
    and ``optimizer`` (the :class:`HeadAdam` returned by :func:`ngd_create`)
    on the head, from one loss evaluation (:func:`ngd_step`).

    The step draws idx (batch_size,) from ``torch.randperm(num_points)``
    and eps (E, L, batch_size) standard normal in the model's dtype from
    ``state.generator`` on its device, in that order. ``loss_kwargs``
    (``unnormalized``, ``y_transposed``) pass to the loss. ``nat_lr`` is ρ;
    ``ramp_steps`` > 0 ramps it from nat_lr/100; ``max_f`` is the
    rate-overflow guard (None turns it off). ``step.rejected`` is a device
    counter of the factors the guards rejected over the step's calls.
    Sharding over a device mesh (``mesh=``, ``state_shardings=``) is not
    ported."""
    if mesh is not None or state_shardings is not None:
        raise NotImplementedError("the NGD step over a mesh is not ported")
    loss_kwargs = dict(loss_kwargs or {})

    def step(state, proj, y):
        gen = state.generator
        mu = state.model.prior.mu
        idx = torch.randperm(num_points, generator=gen,
                             device=gen.device)[:batch_size]
        eps = torch.randn((E, mu.shape[0], batch_size), generator=gen,
                          device=gen.device, dtype=mu.dtype)
        loss, rejected = ngd_step(state, optimizer, proj, y, idx, eps, nat_lr,
                                  ramp_steps, max_f, **loss_kwargs)
        step.rejected = step.rejected + rejected
        return loss

    step.rejected = 0
    return step


@torch.no_grad()
def ngd_to_model(state):
    """Write the NGD covariance back into the model's ``Lu_raw`` (Lu =
    chol(S), S = P⁻¹), so that the posterior and Adam paths see the
    trained q(u). Returns the model, changed in place."""
    s = spd_inverse_from_cholesky(state.prec_chol, block=512)
    s = 0.5 * (s + s.mT)
    lu_raw = state.model.prior.Lu_raw
    lu_raw.copy_(lower_cholesky_inverse(torch.linalg.cholesky(s)))
    return state.model
