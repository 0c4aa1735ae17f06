"""Tests of the benchmark harness, generator, reference and check."""

# a tile small enough for the CPU, with the configurations' widths otherwise
SMALL = {"tile_shape_zyx": [12, 192, 192], "n_spots": 300, "n_beads": 30}

# smaller still, for the cells that deconvolve the fiducial rounds too
TINY = {**SMALL, "tile_shape_zyx": [6, 128, 128], "n_spots": 120, "n_beads": 16}
