"""Tests of the benchmark harness, generator, reference and check."""

# a tile small enough for the CPU, with the configurations' widths otherwise
SMALL = {"tile_shape_zyx": [12, 192, 192], "n_spots": 300, "n_beads": 30}
