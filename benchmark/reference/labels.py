"""26-connected components of equal decoded value over the foreground
(``decoded >= 0``), in numpy and scipy: the 13 forward neighbours of
every foreground voxel are looked up among the sorted foreground indices,
equal-valued pairs become graph edges, and
``scipy.sparse.csgraph.connected_components`` labels the graph. Each
component is named by its first voxel in scan order, so components sort
as a union-find that keeps the smaller index as root sorts them."""

from __future__ import annotations

import itertools

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

_FORWARD = [o for o in itertools.product((-1, 0, 1), repeat=3) if o > (0, 0, 0)]


def label_components_sparse(decoded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(lin, roots)``: the linear index of each foreground voxel in scan
    order and the scan index of its component's first voxel."""
    dec = np.asarray(decoded, np.int32)
    nz, ny, nx = dec.shape
    lin = np.flatnonzero(dec >= 0).astype(np.int64)
    n = lin.size
    if n == 0:
        return lin, np.zeros(0, np.int64)
    vals = dec.ravel()[lin]
    z, rem = np.divmod(lin, ny * nx)
    y, x = np.divmod(rem, nx)
    src, dst = [], []
    for dz, dy, dx in _FORWARD:
        zz, yy, xx = z + dz, y + dy, x + dx
        inside = np.flatnonzero((zz < nz) & (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx))
        target = (zz[inside] * ny + yy[inside]) * nx + xx[inside]
        pos = np.minimum(np.searchsorted(lin, target), n - 1)
        hit = (lin[pos] == target) & (vals[pos] == vals[inside])
        src.append(inside[hit])
        dst.append(pos[hit])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    graph = coo_matrix((np.ones(src.size, np.int8), (src, dst)), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    return lin, lin[first[comp]]
