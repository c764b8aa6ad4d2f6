"""Minimal ``.h5ad`` ingestion without the anndata package (a copy of
``gpzoo_tpu/data/io.py``: host numpy, no torch).

The reference workflows load spatial datasets through
squidpy/scanpy/anndata (e.g. ``sq.datasets.slideseqv2()``); none of those
are required here — an AnnData ``.h5ad`` file is plain HDF5 with a
documented layout, and the training pipeline only needs three things:
the counts matrix ``X``, the spatial coordinates ``obsm/spatial``, and
optionally an ``obs`` column for group labels. This reader pulls exactly
those with h5py.
"""

from __future__ import annotations

import numpy as np


def _read_matrix(node):
    """Dense dataset or CSR/CSC group → dense ndarray."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return np.asarray(node)
    enc = node.attrs.get("encoding-type", b"")
    enc = enc.decode() if isinstance(enc, bytes) else str(enc)
    shape = tuple(node.attrs["shape"])
    data = np.asarray(node["data"])
    indices = np.asarray(node["indices"])
    indptr = np.asarray(node["indptr"])
    from scipy import sparse

    cls = sparse.csc_matrix if "csc" in enc else sparse.csr_matrix
    return np.asarray(cls((data, indices, indptr), shape=shape).todense())


def _read_obs_column(f, name):
    """An obs column: plain array, or AnnData categorical (codes +
    categories), old or new encoding."""
    obs = f["obs"]
    node = obs[name]
    import h5py

    if isinstance(node, h5py.Group):  # categorical (new encoding)
        codes = np.asarray(node["codes"])
        cats = np.asarray(node["categories"])
        return codes, cats
    values = np.asarray(node)
    if f"__categories/{name}" in obs:  # categorical (old encoding)
        cats = np.asarray(obs[f"__categories/{name}"])
        return values, cats
    return values, None


def read_h5ad(path, obs_columns=()):
    """Read counts / spatial coords / obs columns from an .h5ad file.

    Returns a dict with:
      "X"       — (n_obs, n_vars) dense counts,
      "spatial" — (n_obs, 2) coordinates (None if absent),
      "obs"     — {name: (values, categories_or_None)} for each requested
                  column (categoricals come back as integer codes, ready
                  to use as MGGP group labels).
    """
    import h5py

    out = {"obs": {}}
    with h5py.File(path, "r") as f:
        out["X"] = _read_matrix(f["X"])
        out["spatial"] = (
            np.asarray(f["obsm"]["spatial"])
            if "obsm" in f and "spatial" in f["obsm"]
            else None
        )
        for name in obs_columns:
            out["obs"][name] = _read_obs_column(f, name)
    return out


def load_train_val(path, sz="scanpy", train_frac=0.95, shuffle_seed=None,
                   obs_columns=()):
    """read_h5ad → (optional shuffle) → ``arrays_to_train_val`` split,
    mirroring the Slideseq notebook's prep (cells 10-11). Returns
    (Dtr, Dval, obs_dict)."""
    from gpzoo_tpu_torch.data.preprocess import arrays_to_train_val

    raw = read_h5ad(path, obs_columns=obs_columns)
    x, y = raw["spatial"], raw["X"]
    if x is None:
        raise ValueError(f"{path} has no obsm/spatial")
    obs = raw["obs"]
    if shuffle_seed is not None:
        perm = np.random.default_rng(shuffle_seed).permutation(x.shape[0])
        x, y = x[perm], y[perm]
        obs = {k: (v[perm], cats) for k, (v, cats) in obs.items()}
    dtr, dval = arrays_to_train_val(x, y, train_frac=train_frac, sz=sz)
    # slice obs columns to match the split so group labels stay aligned
    ntr = dtr["X"].shape[0]
    for name, (vals, cats) in obs.items():
        dtr[f"obs_{name}"] = vals[:ntr]
        if dval is not None:
            dval[f"obs_{name}"] = vals[ntr:]
    return dtr, dval, obs
