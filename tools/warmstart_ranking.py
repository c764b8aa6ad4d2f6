"""The warm start's ranking check in the JAX package and in the port, on
the CPU, at the widths given:

    python tools/warmstart_ranking.py [N D L_TOTAL L_SPATIAL [PNMF_STEPS]]

(default 4000 200 20 10 1500: examples/slideseq_mggp_hybrid.py's default
data at its full-scale factor counts). Each package trains the example's
PNMF (E = 1, unnormalized, Adam 1e-2, full batch) on simulate_nsf_counts'
seed-0 data from its own random init and ranks the softmax-normalized
factors by Moran's I (``warmstart.hybrid_mggp_from_pnmf``). The check,
as ``chip_smoke.py``'s [warmstart] makes it: the best-match correlation
of the simulated spatial factors with the top ``L_SPATIAL`` ranked
factors, summed, is no lower than with the best ``L_SPATIAL`` of all.
Prints both sums and the verdict for each package; about half a minute at
the default widths.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import gpzoo_tpu as gz  # noqa: E402
import gpzoo_tpu_torch as gt  # noqa: E402
from gpzoo_tpu.train import (TrainState, make_scan_runner,  # noqa: E402
                             make_train_step, pnmf_negative_elbo)

GROUPS, M_PER_GROUP = 4, 10


def jax_factors(y, x, groups, l_total, l_spatial, steps):
    """(softmax factors (L, N), Moran order) of the JAX example's PNMF."""
    key = jax.random.PRNGKey(509)
    prior = gz.gps.GaussianPrior.create(key, x.shape[0], L=l_total)
    pnmf = gz.models.PNMF.create(jax.random.fold_in(key, 1), prior, y.shape[0],
                                 x.shape[0], L=l_total)
    opt = optax.adam(1e-2)
    state = TrainState.create(pnmf, opt, key)
    step = make_train_step(pnmf_negative_elbo, opt,
                           static_kwargs={"E": 1, "unnormalized": True})
    runner = make_scan_runner(step, 100)
    for _ in range(steps // 100):
        state, _ = runner(state, jax.numpy.asarray(y))
    _, order, _ = gz.warmstart.hybrid_mggp_from_pnmf(
        jax.random.fold_in(key, 2), state.model, jax.numpy.asarray(x),
        jax.numpy.asarray(groups), L_spatial=l_spatial, m_per_group=M_PER_GROUP,
        n_groups=GROUPS)
    qf, _ = state.model.prior()
    return np.asarray(jax.nn.softmax(qf.mean, axis=-1), np.float64), np.asarray(order)


def port_factors(y, x, groups, l_total, l_spatial, steps):
    """(softmax factors (L, N), Moran order) of the port's PNMF."""
    gen = torch.Generator().manual_seed(509)
    cfg = gt.PNMFConfig(D=y.shape[0], N=x.shape[0], L=l_total, E=1)
    pnmf = cfg.build(gen)
    step = gt.make_train_step(gt.pnmf_negative_elbo, cfg.optimizer(pnmf), cfg.N, cfg.L,
                              gen, E=1, loss_kwargs={"unnormalized": True})
    gt.run_steps(step, pnmf, (torch.from_numpy(y),), steps)
    _, order, _ = gt.warmstart.hybrid_mggp_from_pnmf(
        gen, pnmf, torch.from_numpy(x), torch.from_numpy(groups), L_spatial=l_spatial,
        m_per_group=M_PER_GROUP, n_groups=GROUPS)
    with torch.no_grad():
        factors = torch.softmax(pnmf.prior()[0].mean, dim=-1)
    return factors.double().numpy(), order


def main(n=4000, d=200, l_total=20, l_spatial=10, steps=1500):
    coords, counts, truth = gz.data.simulate_nsf_counts(N=n, D=d, L=l_spatial, seed=0)
    groups = np.random.default_rng(0).integers(0, GROUPS, n)
    print(f"N={n} D={d} L_total={l_total} L_spatial={l_spatial}, {steps} PNMF steps")
    for name, fit in (("gpzoo_tpu", jax_factors), ("gpzoo_tpu_torch", port_factors)):
        factors, order = fit(np.asarray(counts), np.asarray(coords), groups, l_total,
                             l_spatial, steps)
        top = gz.data.best_match_correlation(truth, factors[order[:l_spatial]]).sum()
        best = gz.data.best_match_correlation(truth, factors).sum()
        print(f"  {name}: top-ranked {l_spatial} {top:.4f}, best {l_spatial} of all "
              f"{best:.4f}: {'passes' if top >= best - 1e-9 else 'fails'}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
