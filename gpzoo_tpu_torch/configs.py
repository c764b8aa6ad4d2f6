"""Workload configurations (port of ``SVGPRegressionConfig``,
``PNMFConfig``, ``NSFConfig``, ``SlideseqNSFConfig``, ``VNNGP_SHAPES``,
``VNNGPConfig``, ``MGGPNSFConfig``, ``HybridNSFConfig`` and
``SlideseqHybridMGGPConfig`` from ``gpzoo_tpu/configs.py``).

Each ``build`` draws its random leaves from a ``torch.Generator`` and puts
the model on that generator's device (or X's), so the entry points run on
the card unless the caller hands them CPU tensors or a CPU generator."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gpzoo_tpu_torch.bijectors import init_softplus, softplus_inverse
from gpzoo_tpu_torch.gps.gaussian_prior import GaussianPrior
from gpzoo_tpu_torch.gps.mggp import MGGPSVGP
from gpzoo_tpu_torch.gps.svgp import SVGP, WSVGP, LowRankWSVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP
from gpzoo_tpu_torch.kernels.mggp import MGGPNSFRBF
from gpzoo_tpu_torch.kernels.rbf import NSFRBF, RBF
from gpzoo_tpu_torch.models.factorization import (MGGPNSF, NBNSF, NSF, PNMF,
                                                  HybridNSF, PoissonFactorization)
from gpzoo_tpu_torch.models.likelihoods import GaussianLikelihood


def _inducing_subset(generator, X, M):
    """Rows of X for Z: M distinct ones, or M drawn with replacement when
    X has fewer than M rows."""
    if M > X.shape[0]:
        idx = torch.randint(X.shape[0], (M,), generator=generator,
                            device=X.device)
    else:
        idx = torch.randperm(X.shape[0], generator=generator,
                             device=X.device)[:M]
    return X[idx].clone()


def _apply_likelihood(model, likelihood, nb_total_count):
    """The NSF head for the config's ``likelihood``: ``"poisson"`` keeps
    it, ``"nb"`` makes it an :class:`NBNSF` over the same leaves with
    r_raw = init_softplus(nb_total_count) for every gene."""
    if likelihood == "poisson":
        return model
    if likelihood == "nb":
        w = model.W_raw.detach()
        r_raw = torch.as_tensor(init_softplus(np.full(w.shape[0], float(nb_total_count))),
                                dtype=w.dtype, device=w.device)
        return NBNSF(model.prior, w, model.V_raw.detach(), r_raw)
    raise ValueError(f"likelihood must be 'poisson' or 'nb', got {likelihood!r}")


def freeze_(model, trainable):
    """Set ``requires_grad`` of every parameter to ``trainable(path)``,
    with ``path`` the dotted name (``"prior.kernel.sigma"``). Returns the
    model."""
    for path, p in model.named_parameters():
        p.requires_grad_(bool(trainable(path)))
    return model


def _adam(model, lr):
    """Adam over the model's trainable parameters."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)


def _random_svgp(cls, generator, kernel, dim, M, jitter, dt):
    """The JAX ``SVGP.create``/``WSVGP.create`` state: Z ~ N(0, 1) (M, dim),
    mu = 0 (M,), Lu_raw ~ N(0, 1) (M, M), drawn in that order."""
    dev = generator.device
    z = torch.randn((M, dim), generator=generator, dtype=dt, device=dev)
    lu_raw = torch.randn((M, M), generator=generator, dtype=dt, device=dev)
    return cls(kernel, Z=z, mu=torch.zeros((M,), dtype=dt, device=dev),
               Lu_raw=lu_raw, jitter=jitter)


@dataclasses.dataclass
class SVGPRegressionConfig:
    """1-D SVGP regression toy (SVGP.ipynb cells 2-9): n = 10k points of
    2 sin(2x) + ε, RBF(σ=1, ℓ=5), M = 500, jitter 1e-3, a Gaussian
    likelihood with raw noise 0.1, Adam(1e-3), E = 20; ``whitened`` takes a
    WSVGP. Every leaf trains."""

    n: int = 10_000
    M: int = 500
    sigma: float = 1.0
    lengthscale: float = 5.0
    jitter: float = 1e-3
    noise: float = 0.1
    lr: float = 1e-3
    E: int = 20
    steps: int = 200
    whitened: bool = False

    def build(self, generator, dtype=torch.float32):
        """GaussianLikelihood over an SVGP (WSVGP) with a scalar RBF, on
        ``generator``'s device as ``dtype``: Z ~ N(0, 1) (M, 1),
        Lu_raw ~ N(0, 1), mu = 0."""
        dev = generator.device
        kernel = RBF(torch.tensor(self.sigma, dtype=dtype, device=dev),
                     torch.tensor(self.lengthscale, dtype=dtype, device=dev),
                     input_dim=1)
        gp = _random_svgp(WSVGP if self.whitened else SVGP, generator, kernel, 1,
                          self.M, self.jitter, dtype)
        return GaussianLikelihood.create(gp, noise=self.noise)

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        return _adam(model, self.lr)


@dataclasses.dataclass
class PNMFConfig:
    """Probabilistic NMF benchmark (PNMF_benchmarks.ipynb cells 8-14):
    L = 4, Adam(1e-2), E = 20, full batch. Every leaf trains."""

    D: int = 80
    N: int = 1000
    L: int = 4
    lr: float = 1e-2
    E: int = 20
    steps: int = 10_000

    def build(self, generator, dtype=torch.float32):
        """PNMF on ``generator``'s device as ``dtype``: prior mean ~ N(0, 1)
        and scale_raw ~ U(0, 1) (L, N), scale_pf = 1, W ~ U(0, 1) (D, L),
        V = 1."""
        dev = generator.device
        prior = GaussianPrior(
            torch.randn((self.L, self.N), generator=generator, dtype=dtype, device=dev),
            torch.rand((self.L, self.N), generator=generator, dtype=dtype, device=dev))
        return PNMF(prior,
                    torch.rand((self.D, self.L), generator=generator, dtype=dtype,
                               device=dev),
                    torch.ones((self.N,), dtype=dtype, device=dev))

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        return _adam(model, self.lr)


@dataclasses.dataclass
class NSFConfig:
    """NSF spatial factorization benchmark (NSF_benchmarks.ipynb cells
    9-21): L = 4, M ∈ {100, 250, 500, 1000}, NSF_RBF, jitter 1e-1,
    Adam(5e-3), full batch, E = 20; ``likelihood="nb"`` takes NBNSF with
    r = ``nb_total_count``. Every leaf trains, Z and the kernel too."""

    D: int = 80
    N: int = 1000
    L: int = 4
    M: int = 500
    sigma: float = 1.0
    lengthscale: float = 1.0
    jitter: float = 1e-1
    lr: float = 5e-3
    E: int = 20
    steps: int = 10_000
    likelihood: str = "poisson"
    nb_total_count: float = 10.0

    def build(self, generator, X=None, dtype=torch.float32):
        """NSF over an SVGP with an L-batched RBF, on ``generator``'s device
        (X's dtype if given): Z ~ N(0, 1) (M, 2), or M rows of X (distinct
        where X has M rows, else drawn with replacement); mu = 0 (M,) and
        Lu_raw ~ N(0, 1) (M, M), shared by the factors; W ~ U(0, 1), V = 1."""
        dt = dtype if X is None else X.dtype
        dev = generator.device
        kernel = NSFRBF.create(sigma=self.sigma, lengthscale=self.lengthscale,
                               L=self.L, dtype=dt, device=dev)
        gp = _random_svgp(SVGP, generator, kernel, 2, self.M, self.jitter, dt)
        if X is not None:
            gp.Z = nn.Parameter(_inducing_subset(generator, X, self.M))
        model = NSF(gp,
                    W_raw=torch.rand((self.D, self.L), generator=generator, dtype=dt,
                                     device=dev),
                    V_raw=torch.ones((self.N,), dtype=dt, device=dev))
        return _apply_likelihood(model, self.likelihood, self.nb_total_count)

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        return _adam(model, self.lr)


@dataclasses.dataclass
class SlideseqNSFConfig:
    """The north-star workload (Slideseq_NSF_newest_version.ipynb cells
    20-29): ~45k spots, L=20, M=3000, NSF_RBF(σ=1), jitter=1e-1,
    Lu = I, mu ~ N(0,1), Z = data subset (frozen), Adam(2e-3),
    batch 7000, E=1, unnormalized Poisson log-lik.

    ``rank`` > 0 swaps the full (L, M, M) q(u) Cholesky for the whitened
    low-rank-plus-diagonal :class:`LowRankWSVGP` at that rank;
    ``likelihood="nb"`` swaps the Poisson head for :class:`NBNSF` with a
    trainable per-gene dispersion starting at ``nb_total_count``."""

    D: int = 4000
    N: int = 45_000
    L: int = 20
    M: int = 3000
    sigma: float = 1.0
    lengthscale: float = 1.0
    jitter: float = 1e-1
    lr: float = 2e-3
    E: int = 1
    batch_size: int = 7000
    rank: int = 0
    likelihood: str = "poisson"
    nb_total_count: float = 10.0

    def build(self, generator, X):
        """Initial NSF on X's device and dtype, drawn from ``generator``
        (which must live on the same device): Z a random subset of X's
        rows, mu ~ N(0, 1), Lu = I (or, with ``rank``, D = I and
        V ~ 0.01·N(0, 1), (L, M, rank): V must not start at 0, a
        stationary point), W ~ U(0, 1), V = 1. Frozen leaves get
        ``requires_grad=False`` per :meth:`trainable`."""
        dev, dt = X.device, X.dtype
        kernel = NSFRBF.create(sigma=self.sigma, lengthscale=self.lengthscale,
                               L=self.L, dtype=dt, device=dev)
        z = _inducing_subset(generator, X, self.M)
        mu = torch.randn((self.L, self.M), generator=generator, dtype=dt,
                         device=dev)
        if self.rank > 0:
            gp = LowRankWSVGP(
                kernel, Z=z, mu=mu,
                V=1e-2 * torch.randn((self.L, self.M, self.rank),
                                     generator=generator, dtype=dt, device=dev),
                d_raw=softplus_inverse(torch.ones((self.L, self.M), dtype=dt,
                                                  device=dev)),
                jitter=self.jitter)
        else:
            # Lu = identity: raw zeros map through exp-diag to I
            gp = SVGP(kernel, Z=z, mu=mu,
                      Lu_raw=torch.zeros((self.L, self.M, self.M), dtype=dt,
                                         device=dev),
                      jitter=self.jitter)
        model = NSF(
            gp,
            W_raw=torch.rand((self.D, self.L), generator=generator, dtype=dt,
                             device=dev),
            V_raw=torch.ones((self.N,), dtype=dt, device=dev),
        )
        model = _apply_likelihood(model, self.likelihood, self.nb_total_count)
        return freeze_(model, self.trainable)

    def trainable(self, path: str) -> bool:
        """Z and kernel hyperparameters frozen (notebook cells 20, 25-26);
        mu, Lu (or V and d_raw), W, V_raw and r_raw train."""
        return not (path.endswith(".Z") or ".kernel." in path)

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        params = [p for p in model.parameters() if p.requires_grad]
        return torch.optim.Adam(params, lr=self.lr)


#: Shapes of the VNNGP benchmark legs, (N, D, L, M, K, batch).
VNNGP_SHAPES = {
    "quick": (10_000, 50, 10, 250, 8, 1000),
    "full": (100_000, 500, 10, 1000, 8, 5000),
}


@dataclasses.dataclass
class VNNGPConfig:
    """Nearest-neighbour NSF (nnnsf_visium_anim_experiment.ipynb cells
    9-13): NSF2(VNNGP(NSF_RBF(L=10), M=1000, K=8)), every leaf trained by
    Adam(5e-3)."""

    D: int = 100
    N: int = 3000
    L: int = 10
    M: int = 1000
    K: int = 8
    sigma: float = 1.0
    lengthscale: float = 1.0
    jitter: float = 1e-1
    lr: float = 5e-3
    E: int = 3

    def build(self, generator, X):
        """Initial NSF over a VNNGP on X's device and dtype, drawn from
        ``generator`` (on the same device): Z a random subset of X's rows,
        mu = 0 (M,) and Lu = I (M, M) shared by all factors, an L-batched
        kernel with σ and ℓ from the config, W ~ U(0, 1), V = 1."""
        dev, dt = X.device, X.dtype
        kernel = NSFRBF.create(sigma=self.sigma, lengthscale=self.lengthscale,
                               L=self.L, input_dim=X.shape[1], dtype=dt,
                               device=dev)
        gp = VNNGP(
            kernel,
            Z=_inducing_subset(generator, X, self.M),
            mu=torch.zeros((self.M,), dtype=dt, device=dev),
            # Lu = identity: raw zeros map through exp-diag to I
            Lu_raw=torch.zeros((self.M, self.M), dtype=dt, device=dev),
            K=self.K,
            jitter=self.jitter,
        )
        model = NSF(
            gp,
            W_raw=torch.rand((self.D, self.L), generator=generator, dtype=dt,
                             device=dev),
            V_raw=torch.ones((self.N,), dtype=dt, device=dev),
        )
        return freeze_(model, self.trainable)

    def trainable(self, path: str) -> bool:
        """Every leaf trains: Z, the kernel, mu, Lu, W and V."""
        return True

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        params = [p for p in model.parameters() if p.requires_grad]
        return torch.optim.Adam(params, lr=self.lr)


@dataclasses.dataclass
class MGGPNSFConfig:
    """MGGP-NSF on grouped spatial data
    (Slideseq_MGGP_NSF_newest_version.ipynb cells 20-29): L=20,
    M=215/group over 14 groups, MGGPNSFRBF(σ=1, ℓ=1.5, α=2.0),
    jitter=1e-1, Adam(1e-3), batch 7000, E=1, unnormalized Poisson."""

    D: int = 100
    N: int = 10_000
    L: int = 20
    M_per_group: int = 215
    n_groups: int = 14
    sigma: float = 1.0
    lengthscale: float = 1.5
    group_diff_param: float = 2.0
    jitter: float = 1e-1
    lr: float = 1e-3
    E: int = 1
    batch_size: int = 7000

    @property
    def M(self):
        return self.M_per_group * self.n_groups

    def build(self, generator, X, groups=None):
        """Initial MGGP-NSF on X's device and dtype, drawn from
        ``generator`` (on the same device): mu = 0 (M,) and Lu_raw ~ N(0, 1)
        (M, M) shared by all factors, W ~ U(0, 1), V = 1. With ``groups``
        (N,) the inducing points are M_per_group rows of each group, drawn
        by ``np.random.default_rng(0)`` as the JAX config draws them, so
        both packages pick the same Z and groupsZ; without, Z ~ N(0, 1) and
        groupsZ uniform. Frozen leaves get ``requires_grad=False`` per
        :meth:`trainable`."""
        dev, dt = X.device, X.dtype
        kernel = MGGPNSFRBF.create(
            sigma=self.sigma, lengthscale=self.lengthscale,
            group_diff_param=self.group_diff_param, n_groups=self.n_groups,
            L=self.L, input_dim=X.shape[1], dtype=dt, device=dev)
        if groups is None:
            z = torch.randn((self.M, X.shape[1]), generator=generator,
                            dtype=dt, device=dev)
            gz = torch.randint(self.n_groups, (self.M,), generator=generator,
                               device=dev)
        else:
            xn = X.detach().cpu().numpy()
            gn = np.asarray(torch.as_tensor(groups).cpu())
            rng = np.random.default_rng(0)
            zs, gzs = [], []
            for g in range(self.n_groups):
                rows = np.flatnonzero(gn == g)
                take = rng.choice(rows, size=self.M_per_group,
                                  replace=len(rows) < self.M_per_group)
                zs.append(xn[take])
                gzs.append(np.full(self.M_per_group, g))
            z = torch.as_tensor(np.concatenate(zs), dtype=dt, device=dev)
            gz = torch.as_tensor(np.concatenate(gzs), device=dev)
        gp = MGGPSVGP(
            kernel, Z=z, groupsZ=gz,
            mu=torch.zeros((self.M,), dtype=dt, device=dev),
            Lu_raw=torch.randn((self.M, self.M), generator=generator,
                               dtype=dt, device=dev),
            jitter=self.jitter)
        model = MGGPNSF(
            gp,
            W_raw=torch.rand((self.D, self.L), generator=generator, dtype=dt,
                             device=dev),
            V_raw=torch.ones((self.N,), dtype=dt, device=dev),
        )
        return freeze_(model, self.trainable)

    def trainable(self, path: str) -> bool:
        """Z frozen, every other float leaf trains, the group embedding
        included (the JAX MGGP benchmark's mask); the integer groupsZ is a
        buffer and never trains."""
        return not path.endswith(".Z")

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        params = [p for p in model.parameters() if p.requires_grad]
        return torch.optim.Adam(params, lr=self.lr)


def _hybrid(generator, gp, prior2, D, N, L, T, dt, dev):
    """HybridNSF over ``gp`` and the mean-field ``prior2``: spatial and
    mean-field loadings ~ U(0, 1), (D, L) and (D, T), and V = 1 (the JAX
    ``HybridNSF.create``)."""
    def uniform(cols):
        return torch.rand((D, cols), generator=generator, dtype=dt, device=dev)
    return HybridNSF(PoissonFactorization(gp, uniform(L)),
                     PoissonFactorization(prior2, uniform(T)),
                     torch.ones((N,), dtype=dt, device=dev))


@dataclasses.dataclass
class HybridNSFConfig:
    """Hybrid NSF benchmark (NSF_Hybrid_benchmark.ipynb cells 11-23):
    L=4 spatial + T=3 mean-field factors, M=23²=529 grid inducing points
    over [-2,2]², NSF_RBF(σ=1, ℓ=0.1), jitter=1e-3, Lu=1e-2·I, cf mean = 0
    with scale_pf=1e-1, Adam(1e-3), full batch, E=1000."""

    D: int = 80
    N: int = 800
    L: int = 4
    T: int = 3
    M_grid: int = 23
    sigma: float = 1.0
    lengthscale: float = 0.1
    jitter: float = 1e-3
    scale_pf: float = 1e-1
    lr: float = 1e-3
    E: int = 1000
    steps: int = 10_000

    @property
    def M(self):
        return self.M_grid ** 2

    def build(self, generator, dtype=torch.float32):
        """Initial HybridNSF on ``generator``'s device as ``dtype``: Z the
        M_grid² grid over [-2, 2]², mu ~ 0.1·N(0, 1) (L, M), Lu = 1e-2·I per
        factor, cf mean 0 and scale_raw ~ U(0, 1) (T, N), loadings ~ U(0, 1),
        V = 1. Frozen leaves get ``requires_grad=False`` per
        :meth:`trainable`."""
        dev, dt = generator.device, dtype
        kernel = NSFRBF.create(sigma=self.sigma, lengthscale=self.lengthscale,
                               L=self.L, dtype=dt, device=dev)
        side = torch.linspace(-2.0, 2.0, self.M_grid, dtype=dt, device=dev)
        zx, zy = torch.meshgrid(side, side, indexing="ij")
        lu_raw = torch.zeros((self.L, self.M, self.M), dtype=dt, device=dev)
        lu_raw.diagonal(dim1=-2, dim2=-1).fill_(float(np.log(1e-2)))
        gp = SVGP(kernel, Z=torch.stack([zx.reshape(-1), zy.reshape(-1)], dim=-1),
                  mu=0.1 * torch.randn((self.L, self.M), generator=generator,
                                       dtype=dt, device=dev),
                  Lu_raw=lu_raw, jitter=self.jitter)
        prior2 = GaussianPrior(
            torch.zeros((self.T, self.N), dtype=dt, device=dev),
            torch.rand((self.T, self.N), generator=generator, dtype=dt, device=dev),
            self.scale_pf)
        model = _hybrid(generator, gp, prior2, self.D, self.N, self.L, self.T, dt, dev)
        return freeze_(model, self.trainable)

    def trainable(self, path: str) -> bool:
        """Cell 15's requires_grad flips: σ, cf.W, the cf mean and V frozen;
        ℓ, Z, mu, Lu, sf.W and the cf scale train."""
        if path.endswith("kernel.sigma"):
            return False
        return path not in ("cf.W_raw", "cf.prior.mean", "V_raw")

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        return _adam(model, self.lr)


@dataclasses.dataclass
class SlideseqHybridMGGPConfig:
    """Slideseq-scale Hybrid-MGGP fine-tune
    (Slideseq_MGGP_hybrid_new_version-Copy1.ipynb cells 29-35): L=10
    spatial factors on an MGGP SVGP (M = 215 × 14 groups = 3,010,
    MGGP_NSF_RBF(σ=1, ℓ=4, α=0.7), jitter=1e-2) + T=10 mean-field factors,
    batch 6000, E=3, the kernel frozen, a flat Adam(1e-3). ``build`` makes
    the shapes of the PNMF-warm-started model synthetically, as the JAX
    config does."""

    D: int = 4000
    N: int = 45_000
    L: int = 10
    T: int = 10
    M_per_group: int = 215
    n_groups: int = 14
    sigma: float = 1.0
    lengthscale: float = 4.0
    group_diff_param: float = 0.7
    jitter: float = 1e-2
    lr: float = 1e-3
    E: int = 3
    batch_size: int = 6000
    steps: int = 24_000

    @property
    def M(self):
        return self.M_per_group * self.n_groups

    def build(self, generator, X, groups):
        """Initial Hybrid-MGGP on X's device and dtype, drawn from
        ``generator`` (on the same device): Z and groupsZ the rows of X and
        groups at M distinct spots drawn by ``np.random.default_rng(0)``, as
        the JAX config draws them (unstratified), mu ~ 0.1·N(0, 1) (L, M),
        Lu = I per factor, cf mean ~ N(0, 1) and scale_raw ~ U(0, 1) (T, N)
        with scale_pf = 1, loadings ~ U(0, 1), V = 1. Frozen leaves get
        ``requires_grad=False`` per :meth:`trainable`."""
        dev, dt = X.device, X.dtype
        kernel = MGGPNSFRBF.create(
            sigma=self.sigma, lengthscale=self.lengthscale,
            group_diff_param=self.group_diff_param, n_groups=self.n_groups,
            L=self.L, input_dim=X.shape[1], dtype=dt, device=dev)
        take = np.random.default_rng(0).choice(X.shape[0], size=self.M, replace=False)
        take = torch.as_tensor(take, device=dev)
        gp = MGGPSVGP(
            kernel, Z=X[take].clone(),
            groupsZ=torch.as_tensor(groups, device=dev)[take],
            mu=0.1 * torch.randn((self.L, self.M), generator=generator, dtype=dt,
                                 device=dev),
            # Lu = identity: raw zeros map through exp-diag to I
            Lu_raw=torch.zeros((self.L, self.M, self.M), dtype=dt, device=dev),
            jitter=self.jitter)
        prior2 = GaussianPrior(
            torch.randn((self.T, self.N), generator=generator, dtype=dt, device=dev),
            torch.rand((self.T, self.N), generator=generator, dtype=dt, device=dev))
        model = _hybrid(generator, gp, prior2, self.D, self.N, self.L, self.T, dt, dev)
        return freeze_(model, self.trainable)

    def trainable(self, path: str) -> bool:
        """Cell 32: every kernel hyperparameter (the embedding too) frozen;
        Z, mu, Lu, V and both halves' loadings and mean-field parameters
        train."""
        return ".kernel." not in path

    def optimizer(self, model):
        """Adam over the model's trainable parameters."""
        return _adam(model, self.lr)
