"""Workload configurations (port of ``SlideseqNSFConfig``,
``VNNGP_SHAPES`` and ``VNNGPConfig`` from ``gpzoo_tpu/configs.py``)."""

from __future__ import annotations

import dataclasses

import torch

from gpzoo_tpu_torch.gps.svgp import SVGP
from gpzoo_tpu_torch.gps.vnngp import VNNGP
from gpzoo_tpu_torch.kernels.rbf import NSFRBF
from gpzoo_tpu_torch.models.factorization import NSF


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


def freeze_(model, trainable):
    """Set ``requires_grad`` of every parameter to ``trainable(path)``,
    with ``path`` the dotted name (``"prior.kernel.sigma"``). Returns the
    model."""
    for path, p in model.named_parameters():
        p.requires_grad_(bool(trainable(path)))
    return model


@dataclasses.dataclass
class SlideseqNSFConfig:
    """The north-star workload (Slideseq_NSF_newest_version.ipynb cells
    20-29): ~45k spots, L=20, M=3000, NSF_RBF(σ=1), jitter=1e-1,
    Lu = I, mu ~ N(0,1), Z = data subset (frozen), Adam(2e-3),
    batch 7000, E=1, unnormalized Poisson log-lik."""

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

    def build(self, generator, X):
        """Initial NSF on X's device and dtype, drawn from ``generator``
        (which must live on the same device): Z a random subset of X's
        rows, mu ~ N(0, 1), Lu = I, W ~ U(0, 1), V = 1. Frozen leaves get
        ``requires_grad=False`` per :meth:`trainable`."""
        dev, dt = X.device, X.dtype
        kernel = NSFRBF.create(sigma=self.sigma, lengthscale=self.lengthscale,
                               L=self.L, dtype=dt, device=dev)
        gp = SVGP(
            kernel,
            Z=_inducing_subset(generator, X, self.M),
            mu=torch.randn((self.L, self.M), generator=generator, dtype=dt,
                           device=dev),
            # Lu = identity: raw zeros map through exp-diag to I
            Lu_raw=torch.zeros((self.L, self.M, self.M), dtype=dt, device=dev),
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
        """Z and kernel hyperparameters frozen (notebook cells 20, 25-26)."""
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
