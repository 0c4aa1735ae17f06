"""Shared harness for the PyTorch port's tests: the one place that imports
both the JAX package (the reference) and merfish3d_tpu_torch (the port).

Data crosses between them as numpy arrays only. `reference_state` runs the
reference's hermetic chain and reads what its datastore holds;
`port_store_from_reference` hands that exact state to the port through
`ArrayStore.from_arrays`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from f1_matrix_common import MatrixCase, run_matrix_case

# Under pytest-xdist each worker is a process whose torch intra-op pool
# defaults to one thread per core, so six workers on eight cores spin
# against each other in every parallel region: a hermetic decon case took
# 721 s beside five other port tests and 9 s alone. Every worker imports
# this module while it collects, so the cores are shared out here.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

SLICE_CASE = MatrixCase("uniform", 0.315, False)  # uniform-0.315um-nodecon
SLICE_PIN = 0.9480  # tests/test_f1_matrix.py EXPECTED_F1
F1_TOLERANCE = 0.02
DECON_PINS = {"cells": 0.9655, "uniform": 0.9573}  # tests/test_f1_matrix.py
CNN_PINS = {"cells": 0.9744, "uniform": 0.9666}  # tests/test_f1_matrix.py EXPECTED_F1_CNN
DOG_PINS = {"cells": 0.9655, "uniform": 0.9480}  # the CNN cases with the DoG predictor
CNN_CHECKPOINT = Path(__file__).parent / "data" / "ufish_synthetic_c8.pkl"


def mhd4_codebook(words: int = 24, bits: int = 16, seed: int = 0) -> np.ndarray:
    """(words, bits) 0/1 codebook with 4 on-bits per word."""
    rng = np.random.default_rng(seed)
    cb = np.zeros((words, bits), np.float32)
    for w in range(words):
        cb[w, rng.choice(bits, 4, replace=False)] = 1.0
    return cb


def table_from_frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def reference_state(workdir: Path, case: MatrixCase = SLICE_CASE, ufish_checkpoint=None) -> dict:
    """Run the reference chain for ``case`` and read back its inputs,
    intermediate state and outputs as numpy; with ``ufish_checkpoint``
    the U-FISH CNN of that checkpoint predicts the spot probabilities
    instead of the DoG predictor."""
    from merfish3d_tpu.datastore import qi2labDataStore

    f1 = run_matrix_case(case, workdir, ufish_checkpoint=ufish_checkpoint)
    raw = workdir / "raw"
    ds = qi2labDataStore(workdir / "qi2labdatastore", validate=False)
    n_bits, n_rounds = int(ds.num_bits), int(ds.num_rounds)
    codebook = pd.read_csv(raw / "codebook.csv")
    stage = ds.load_local_stage_position_zyx_um(0, round=0)
    return {
        "case": case,
        "f1": f1,
        "raw_bits": np.stack([np.load(raw / "tile0000" / f"bit{b + 1:03d}.npy") for b in range(n_bits)]),
        "raw_fiducial": np.stack(
            [np.load(raw / "tile0000" / f"fiducial_round{r + 1:03d}.npy") for r in range(n_rounds)]
        ),
        "ground_truth": pd.read_csv(raw / "GT_spots.csv", float_precision="round_trip"),
        "gene_ids": codebook["gene_id"].astype(str).tolist(),
        "codebook": codebook.iloc[:, 1:].to_numpy(np.int64),
        "voxel_size_zyx_um": np.asarray(ds.voxel_size_zyx_um),
        "round_of_bit": np.asarray(
            [ds.load_local_round_linker(tile=0, bit=b) - 1 for b in range(n_bits)]
        ),
        "bit_wavelengths_um": np.asarray(
            [ds.load_local_wavelengths_um(tile=0, bit=b) for b in range(n_bits)]
        ),
        "stage_zyx_um": np.asarray(stage[0]),
        "corrected": np.stack(
            [np.asarray(ds.load_local_corrected_image(tile=0, bit=b)) for b in range(n_bits)]
        ),
        "registered": np.stack(
            [np.asarray(ds.load_local_registered_image(tile=0, bit=b)) for b in range(n_bits)]
        ),
        "probability_u8": np.stack(
            [np.asarray(ds.load_local_feature_predictor_image(tile=0, bit=b, raw=True))
             for b in range(n_bits)]
        ),
        "round_transforms": np.stack(
            [ds.load_local_round_transform_zyx_um(tile=0, round=r) for r in range(n_rounds)]
        ),
        "global_xforms": ds.load_global_coord_xforms_um(0),
        "global_vectors": ds.load_decode_normalization_vectors("global"),
        "iterative_vectors": ds.load_decode_normalization_vectors("iterative"),
        "decoded_table": table_from_frame(ds.load_local_decoded_spots(0)),
        "filtered_table": table_from_frame(ds.load_global_filtered_decoded_spots()),
    }


def port_store_from_reference(ref: dict):
    """The reference's registered state as a port ArrayStore."""
    from merfish3d_tpu_torch.datastore.array_store import ArrayStore

    return ArrayStore.from_arrays(
        gene_ids=ref["gene_ids"],
        codebook_matrix=ref["codebook"],
        voxel_size_zyx_um=ref["voxel_size_zyx_um"],
        round_of_bit=ref["round_of_bit"],
        bit_wavelengths_um=ref["bit_wavelengths_um"],
        stage_positions_zyx_um=ref["stage_zyx_um"][None],
        corrected=ref["corrected"][None],
        fiducial_corrected=ref["raw_fiducial"][None],
        registered=ref["registered"][None],
        feature_predictor=ref["probability_u8"][None],
        round_transforms=ref["round_transforms"][None],
        global_xforms=[ref["global_xforms"]],
    )


def run_port_decode(store, case: MatrixCase = SLICE_CASE) -> dict:
    """The port's decode entry point with the matrix case's parameters,
    on CPU."""
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels

    return decode_pixels(
        store,
        device="cpu",
        minimum_pixels=case.minimum_pixels,
        magnitude_threshold=case.magnitude_threshold,
        lowpass_sigma=case.lowpass_sigma,
        num_tiles=1,
        num_iterations=2,
    )


def match_rows(ref: dict, port: dict, tol_um: float = 0.01) -> float:
    """Fraction of reference rows with a port row of the same gene whose
    global centroid lies within ``tol_um`` (each port row used once)."""
    coords = ("global_z", "global_y", "global_x")
    n_ref = len(ref["gene_id"])
    if n_ref == 0:
        return 1.0
    ref_pts = np.stack([np.asarray(ref[c], float) for c in coords], axis=1)
    port_pts = np.stack([np.asarray(port[c], float) for c in coords], axis=1)
    port_genes = np.asarray(port["gene_id"]).astype(str)
    used = np.zeros(len(port_genes), bool)
    matched = 0
    for i, gene in enumerate(np.asarray(ref["gene_id"]).astype(str)):
        cand = np.flatnonzero((port_genes == gene) & ~used)
        if cand.size == 0:
            continue
        d = np.abs(port_pts[cand] - ref_pts[i]).max(axis=1)
        j = np.argmin(d)
        if d[j] <= tol_um + 1e-9:  # centroids are stored rounded to 0.01 µm
            used[cand[j]] = True
            matched += 1
    return matched / n_ref


# ------------------------------------------------------------ RLGC solves
def gaussian_psf(shape=(7, 11, 11), sigma=(1.2, 1.8, 1.8)) -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    psf = np.exp(-0.5 * ((zz / sigma[0]) ** 2 + (yy / sigma[1]) ** 2 + (xx / sigma[2]) ** 2))
    return (psf / psf.sum()).astype(np.float32)


def observed_counts(shape=(12, 48, 48), n=6, seed=0, background=5.0) -> np.ndarray:
    """Poisson counts of point sources blurred by gaussian_psf (the
    reference's own RLGC test geometry)."""
    import scipy.signal

    rng = np.random.default_rng(seed)
    truth = np.zeros(shape, np.float32)
    for _ in range(n):
        z, y, x = [rng.integers(3, s - 3) for s in shape]
        truth[z, y, x] = rng.uniform(2000, 8000)
    blurred = scipy.signal.fftconvolve(truth, gaussian_psf(), mode="same")
    return rng.poisson(np.clip(blurred, 0, None) + background).astype(np.float32)


def jax_solve(obs, psf, seed, max_iters):
    """JAX _rlgc_core on CPU: (unpadded recon, iterations)."""
    import jax
    import jax.numpy as jnp

    from merfish3d_tpu.ops import rlgc as jrlgc

    pad = jrlgc.linear_fft_pad_width(obs.shape, psf.shape)
    padded = jrlgc.pad_symmetric(jnp.asarray(obs), pad)
    recon, n = jrlgc._rlgc_core(padded, jnp.asarray(psf), jax.random.PRNGKey(seed), pad_width=pad,
                                max_iters=max_iters)
    return np.asarray(jrlgc.remove_padding_zyx(recon, pad)), int(n)


def solves_agree(got, want) -> None:
    """Solves of the same data under different random splits stop at
    different iterations (5 to 11 here, in either package), so each pair
    is held loosely — correlation > 0.95, total energy within 1 % — and
    the stopping rule by the mean iteration count over the solves, within
    1.5."""
    for (g, ng), (w, nw) in zip(got, want):
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.95
        np.testing.assert_allclose(g.sum(), w.sum(), rtol=0.01)
    assert abs(np.mean([n for _, n in got]) - np.mean([n for _, n in want])) <= 1.5


# ------------------------------------------------------- the port's chains
def port_chain(distribution: str, decon: bool, cnn: bool = False):
    """The port's own chain on the 0.315 µm hermetic case on CPU (the port's
    generator, seed 11; RLGC on the readout bits for 12 iterations with
    ``decon``, no fiducial decon, as tests/f1_matrix_common.py runs it;
    with ``cnn`` the repo's trained c8 U-FISH checkpoint predicts the spot
    probabilities): (store, F1)."""
    from merfish3d_tpu_torch.cli.simulation.calculate_f1 import match_spots_f1
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.cli.simulation.pixeldecode import decode_pixels
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    raw = generate_raw_experiment(
        shape=(12, 96, 96), n_spots=170 if distribution == "uniform" else 60, n_genes=20, n_blanks=4,
        seed=11, voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution=distribution, axial_sigma_um=0.44,
    )
    store = convert_data(raw)
    options = dict(ufish_model="synthetic-cnn", ufish_checkpoint=CNN_CHECKPOINT) if cnn else {}
    reg = DataRegistration(store, device="cpu", decon_fiducial=False, decon_readout=decon,
                           decon_max_iters=12, **options)
    assert not cnn or reg._predictor.kind == "cnn"
    reg.register_all_tiles()
    table = decode_pixels(store, device="cpu", minimum_pixels=4, magnitude_threshold=(0.9, 10.0),
                          lowpass_sigma=(3.0, 1.0, 1.0), num_tiles=1, num_iterations=2)
    return store, match_spots_f1(table, raw.ground_truth, radius_um=1.0)["f1"]
