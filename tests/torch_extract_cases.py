"""Decoded volumes for the component extraction tests, on the CPU
(``tests/test_torch_extract.py``) and on the card
(``tests/test_torch_cuda.py``), and the native labeller's components in
the form the port's labeller gives them. Imports neither JAX nor the JAX
package."""

import numpy as np

from merfish3d_tpu_torch import native

# the 26 neighbour offsets (dz, dy, dx) of a voxel
OFFSETS = [
    (dz, dy, dx)
    for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    if (dz, dy, dx) != (0, 0, 0)
]


def random_volume(shape, fg=0.3, words=3, seed=0):
    """Each voxel foreground with probability ``fg``, of one of ``words``
    codewords."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < fg, rng.integers(0, words, shape), -1).astype(np.int16)


def _faces_and_corners():
    """Components on every face, edge and corner of the volume."""
    d = np.full((5, 7, 9), -1, np.int16)
    for z in (0, 4):
        for y in (0, 6):
            for x in (0, 8):
                d[z, y, x] = (z + y + x) % 3
    d[:, 3, 0] = 1
    d[:, 3, 8] = 2
    d[2, 0, :] = 0
    d[2, 6, :] = 1
    d[0, 2:5, 3:6] = 2
    d[4, 2:5, 3:6] = 0
    return d


def _diagonals():
    """Chains that touch only through edges and corners, in each of the 13
    directions and both signs, beside single voxels of another codeword."""
    d = np.full((7, 7, 7), -1, np.int16)
    c = 3
    for dz, dy, dx in OFFSETS:
        d[c + dz, c + dy, c + dx] = 1 if (dz + dy + dx) % 2 else 2
    d[c, c, c] = 1
    d[0, 0, 0], d[1, 1, 1], d[2, 2, 2] = 0, 0, 0
    d[6, 0, 6], d[5, 1, 5] = 2, 0
    return d


def _stripes():
    """Every voxel foreground, codeword x % 2: each x-plane a component of
    its own, beside planes of the other codeword on both sides."""
    x = np.arange(6)
    return np.broadcast_to((x % 2).astype(np.int16), (4, 5, 6)).copy()


def _block_and_snake():
    """A solid cube far larger than a thread block, and a one-voxel-wide
    snake through the volume."""
    d = np.full((24, 24, 24), -1, np.int16)
    d[2:22, 2:22, 2:22] = 5
    d[0, 0, :] = 1
    d[0, :, 23] = 1
    d[:, 23, 23] = 1
    return d


CASES = {
    "empty": np.full((3, 4, 5), -1, np.int16),
    "one_voxel": np.pad(np.zeros((1, 1, 1), np.int16), 2, constant_values=-1),
    "faces_and_corners": _faces_and_corners(),
    "diagonals": _diagonals(),
    "stripes": _stripes(),
    "block_and_snake": _block_and_snake(),
    "random_sparse": random_volume((6, 30, 40), fg=0.05, words=2, seed=1),
    "random_dense": random_volume((5, 20, 30), fg=0.45, words=3, seed=2),
}


def native_roots(decoded: np.ndarray):
    """The native labeller's (lin, roots), its ranks mapped to each
    component's smallest linear index."""
    lin, ranks = native.label_components_sparse(decoded.astype(np.int32))
    if lin.size == 0:
        return lin, ranks
    uniq, first = np.unique(ranks, return_index=True)
    lut = np.empty(int(uniq.max()) + 1, np.int64)
    lut[uniq] = lin[first]
    return lin, lut[ranks]


def spot_volume(shape=(16, 1024, 1024), n_spots=12000, words=90, n_stray=50000, seed=0):
    """A decode's output at a tile's size: spots (three planes of discs of
    radius 2 px) of random codeword, touching and overlapping where they
    fall together, and stray single voxels; ~3 % foreground."""
    rng = np.random.default_rng(seed)
    d = np.full(shape, -1, np.int16)
    offs = np.array([(dz, dy, dx) for dz in (-1, 0, 1) for dy in range(-2, 3) for dx in range(-2, 3)
                     if dy * dy + dx * dx <= 4])
    centers = rng.integers(0, shape, (n_spots, 3))
    pts = np.clip(centers[:, None, :] + offs[None], 0, np.array(shape) - 1).reshape(-1, 3)
    d[tuple(pts.T)] = np.repeat(rng.integers(0, words, n_spots), len(offs)).astype(np.int16)
    stray = rng.integers(0, shape, (n_stray, 3))
    d[tuple(stray.T)] = rng.integers(0, words, n_stray).astype(np.int16)
    return d
