"""Dataset preparation (spatial-transcriptomics ingestion; a copy of
``gpzoo_tpu/data/preprocess.py``: host numpy, no torch).

Numpy-side counterparts of the reference's data-prep block
(``utilities.py:71-129``, itself adapted from the Townes/Engelhardt
nsf-paper, https://github.com/willtownes/nsf-paper — the attribution the
reference carries at utilities.py:46-48). The reference defines these twice with drift (utilities.py:173-
375 shadows :46-170; SURVEY.md §2.6) — one canonical version lives here,
and we keep the *first* definition's behavior of populating ``Dval["idx"]``.

``anndata`` is an optional dependency: :func:`anndata_to_train_val` accepts
an AnnData object when the package is importable, and
:func:`arrays_to_train_val` provides the same split for plain
``(coords, counts)`` arrays.
"""

from __future__ import annotations

import numpy as np


def rescale_spatial_coords(x, box_side=4):
    """Center coords and scale the bounding box to ``box_side^D``
    (utilities.py:71-84); operates on a copy."""
    x = np.array(x, copy=True)
    xmin = x.min(axis=0)
    x -= xmin
    x_gmean = np.exp(np.mean(np.log(x.max(axis=0))))
    x *= box_side / x_gmean
    return x - x.mean(axis=0)


def scanpy_sizefactors(y):
    """Row-sum / median(row-sum) size factors (utilities.py:127-129)."""
    sz = y.sum(axis=1, keepdims=True)
    return sz / np.median(sz)


def _split(x, y, train_frac, sz, dtp):
    n = x.shape[0]
    ntr = round(train_frac * n)
    dtr = {"X": x[:ntr, :], "Y": y[:ntr, :]}
    dval = {"X": x[ntr:, :], "Y": y[ntr:, :]}
    if sz == "constant":
        dtr["sz"] = np.ones((ntr, 1), dtype=dtp)
        dval["sz"] = np.ones((n - ntr, 1), dtype=dtp)
    elif sz == "mean":
        dtr["sz"] = dtr["Y"].mean(axis=1, keepdims=True)
        dval["sz"] = dval["Y"].mean(axis=1, keepdims=True)
    elif sz == "scanpy":
        dtr["sz"] = scanpy_sizefactors(dtr["Y"])
        dval["sz"] = scanpy_sizefactors(dval["Y"])
    else:
        raise ValueError("unrecognized size factors 'sz'")
    dtr["idx"] = np.arange(ntr)
    dval["idx"] = np.arange(ntr, n)
    if ntr >= n:
        dval = None
    return dtr, dval


def arrays_to_train_val(coords, counts, train_frac=0.95, sz="constant",
                        dtp="float32", flip_yaxis=False):
    """Array-native equivalent of :func:`anndata_to_train_val`:
    ``coords (N, D)`` spatial coordinates, ``counts (N, D_genes)`` matrix
    (rows pre-shuffled by the caller, as the reference requires)."""
    x = np.asarray(coords).astype(dtp).copy()
    if flip_yaxis:
        x[:, 1] = -x[:, 1]
    x = rescale_spatial_coords(x)
    y = counts
    if hasattr(y, "toarray"):
        y = y.toarray()
    y = np.asarray(y).astype(dtp)
    return _split(x, y, train_frac, sz, dtp)


def anndata_to_train_val(ad, layer=None, nfeat=None, train_frac=0.95,
                         sz="constant", dtp="float32", flip_yaxis=False):
    """AnnData → train/val dicts (utilities.py:86-125). Requires the
    optional ``anndata`` package only at call time."""
    if nfeat is not None:
        ad = ad[:, :nfeat]
    x = ad.obsm["spatial"]
    y = ad.X if layer is None else ad.layers[layer]
    return arrays_to_train_val(x, y, train_frac=train_frac, sz=sz, dtp=dtp,
                               flip_yaxis=flip_yaxis)
