"""How the arithmetic of d² decides the Moran graph, on the host:

    python tools/knn_graph_arithmetic.py [N]

Builds the KNN graph (``gpzoo_tpu_torch.data.metrics._knn_graph``, six
neighbours) of simulate_nsf_counts' seed-0 coordinates (default N =
45,000) from the float32 coordinates, as the port ranks them, and from
the same coordinates in float64, then prints each graph's entries, the
rows whose neighbour set differs between the two, and how far that moves
Moran's I of a smooth field and of noise. About a minute at the default N.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from gpzoo_tpu_torch.data import metrics, simulate_nsf_counts  # noqa: E402


def main(n=45_000):
    coords = simulate_nsf_counts(N=n, D=1, L=1, seed=0)[0]
    c = coords.astype(np.float64)
    fields = np.stack([np.sin(2.0 * c[:, 0]) * np.cos(c[:, 1]),
                       np.random.default_rng(1).standard_normal(n)], axis=1)
    graphs, morans = {}, {}
    for dtype in (np.float32, np.float64):
        nbr = metrics._knn_neighbours(coords.astype(dtype))
        graph = metrics._symmetrize(nbr)
        graphs[dtype] = np.sort(nbr.numpy(), axis=1)
        morans[dtype] = metrics.morans_i(fields, weights=graph)
        print(f"{np.dtype(dtype).name}: {len(graph[0])} entries; Moran's I smooth "
              f"{morans[dtype][0]:.10f}, noise {morans[dtype][1]:.10f}")
    rows = int((graphs[np.float32] != graphs[np.float64]).any(axis=1).sum())
    gap = np.abs(morans[np.float32] - morans[np.float64])
    print(f"N={n}: {rows} rows with another neighbour set; Moran's I moved "
          f"{gap[0] / abs(morans[np.float64][0]):.3e} relative (smooth), "
          f"{gap[1]:.3e} absolute (noise)")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
