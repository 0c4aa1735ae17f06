"""The port's flow estimator (merfish3d_tpu_torch.ops.flow) against the
JAX reference's (merfish3d_tpu.ops.flow) on the reference's own bead
volumes (tests/test_flow.py), on CPU.

Tolerances: flows within 0.01 px at lattice sites valid in both, peak
ratios and sharpnesses within 1e-4 relative. ``torch.fft`` and XLA's FFT
round differently, and the sub-pixel parabola divides by a curvature, so
the flows are held near the estimator's own precision rather than to the
ulp. A validity decision may differ only where the reference's ratio or
sharpness lies within 1e-4 (relative) of its gate. The relaxation is
float32 elementwise arithmetic on equal inputs: within 1e-5 px, and it
must stop after the same sweep.
"""

import dataclasses

import numpy as np
import pytest
import scipy.ndimage
import torch

from test_flow import _analytic_flow, _bead_volume

from merfish3d_tpu.ops import flow as jflow
from merfish3d_tpu_torch.ops import flow as tflow

FLOW_TOL_PX = 0.01
STAT_RTOL = 1e-4


def _configs(**kw):
    return jflow.SofimaRegistrationConfig(**kw), tflow.SofimaRegistrationConfig(**kw)


def _warped(ref, amp=(0.6, 2.5, 2.0)):
    dz, dy, dx = _analytic_flow(ref.shape, amp=amp)
    coords = np.meshgrid(*[np.arange(s) for s in ref.shape], indexing="ij")
    return scipy.ndimage.map_coordinates(
        ref, [coords[0] - dz, coords[1] - dy, coords[2] - dx], order=1, mode="nearest"
    ).astype(np.float32)


def _near_gate(value, gate):
    return np.abs(value - gate) <= STAT_RTOL * np.maximum(np.abs(gate), 1e-12)


def assert_xcorr_agree(want, got, cfg):
    """(flow, ratio, sharpness) of the two packages: statistics within
    STAT_RTOL, flows within FLOW_TOL_PX where both pass the gates, and the
    gates split only at margins."""
    (wf, wr, ws), (gf, gr, gs) = want, got
    np.testing.assert_allclose(gr, wr, rtol=STAT_RTOL, atol=0)
    np.testing.assert_allclose(gs, ws, rtol=STAT_RTOL, atol=0)
    w_ok = (wr >= cfg.min_peak_ratio) & (ws >= cfg.min_peak_sharpness)
    g_ok = (gr >= cfg.min_peak_ratio) & (gs >= cfg.min_peak_sharpness)
    split = w_ok != g_ok
    assert np.all(_near_gate(wr, cfg.min_peak_ratio)[split] | _near_gate(ws, cfg.min_peak_sharpness)[split])
    both = w_ok & g_ok
    assert both.any()
    assert np.abs(gf - wf)[both].max() <= FLOW_TOL_PX


def _reference_xcorr(ref, moving, **kw):
    import jax.numpy as jnp

    return [np.asarray(v) for v in jflow._patch_xcorr_flow(jnp.asarray(ref), jnp.asarray(moving), **kw)]


# ------------------------------------------------------------------ config
def test_config_matches_reference():
    jcfg, tcfg = _configs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    for kw in ({}, {"stride_zyx": (4, 99, 8), "patch_size_zyx": (8, 16, 16)},
               {"minimum_patch_size_px": 6, "step_divisor": 3}):
        jcfg, tcfg = _configs(**kw)
        assert tcfg.as_metadata() == jcfg.as_metadata()
        for shape in ((16, 1024, 1024), (6, 64, 64), (2, 64, 64), (24, 96, 96), (3, 20, 9)):
            assert tcfg.resolve_patch_and_stride(shape) == jcfg.resolve_patch_and_stride(shape)
    for size, patch, stride in ((16, 10, 5), (1024, 32, 16), (5, 10, 5), (97, 24, 12)):
        np.testing.assert_array_equal(tflow._lattice_starts(size, patch, stride),
                                      jflow._lattice_starts(size, patch, stride))


# ------------------------------------------------------------ cross-correlation
@pytest.mark.parametrize("case", ["smooth", "shifted", "masked"])
def test_patch_xcorr_matches_reference(case):
    cfg = jflow.SofimaRegistrationConfig()
    ref = _bead_volume(shape=(24, 96, 96) if case == "smooth" else (16, 64, 64), n=150, seed=0)
    if case == "smooth":
        moving = _warped(ref)
        kw = dict(patch_size=(12, 24, 24), strides=(6, 12, 12))
    elif case == "shifted":
        moving = np.roll(ref, (1, -2, 3), axis=(0, 1, 2))
        kw = dict(patch_size=(8, 16, 16), strides=(4, 8, 8))
    else:
        moving = np.roll(ref, 2, axis=2)
        ref, moving = ref.copy(), moving.copy()
        ref[:, :, 32:] = 0.0
        moving[:, :, 32:] = 0.0
        kw = dict(patch_size=(8, 16, 16), strides=(4, 8, 8), max_masked=0.5)
    want = _reference_xcorr(ref, moving, **kw)
    got = tflow._patch_xcorr_flow(torch.as_tensor(ref), torch.as_tensor(moving), **kw)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert_xcorr_agree(want, got, cfg)
    if case == "masked":
        np.testing.assert_array_equal(got[1] == 0.0, want[1] == 0.0)
        assert (got[1] == 0.0).any()


def test_patch_xcorr_batch_size_does_not_change_results():
    ref = _bead_volume(shape=(16, 64, 64), n=80, seed=3)
    moving = _warped(ref, amp=(0.4, 1.5, 1.2))
    kw = dict(patch_size=(8, 16, 16), strides=(4, 8, 8))
    whole = tflow._patch_xcorr_flow(torch.as_tensor(ref), torch.as_tensor(moving), batch_size=512, **kw)
    pieces = tflow._patch_xcorr_flow(torch.as_tensor(ref), torch.as_tensor(moving), batch_size=7, **kw)
    for a, b in zip(whole, pieces):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_patch_xcorr_refuses_an_empty_ring():
    vol = torch.zeros((8, 16, 16))
    with pytest.raises(ValueError):
        tflow._patch_xcorr_flow(vol, vol, patch_size=(8, 16, 16), strides=(4, 8, 8), peak_radius=2)


def test_clean_flow_exact():
    rng = np.random.default_rng(4)
    flow = rng.normal(0.0, 3.0, (3, 5, 6, 3)).astype(np.float32)
    flow[0, 0, 0] = 40.0  # past max_magnitude
    flow[1, 1, 1] = (0.0, 9.0, 0.0)  # past max_deviation
    ratios = rng.uniform(0.8, 3.0, (3, 5, 6)).astype(np.float32)
    sharps = rng.uniform(0.8, 3.0, (3, 5, 6)).astype(np.float32)
    for kw in ({}, {"min_peak_ratio": 10.0}, {"max_deviation": 2.0}):
        jcfg, tcfg = _configs(**kw)
        np.testing.assert_array_equal(tflow._clean_flow(flow, ratios, sharps, tcfg),
                                      jflow._clean_flow(flow, ratios, sharps, jcfg))


# -------------------------------------------------------------- relaxation
@pytest.mark.parametrize("lattice,smoothness,tolerance", [((3, 7, 7), 0.25, 1e-4), ((2, 9, 5), 1.0, 1e-6),
                                                          ((1, 1, 1), 0.25, 1e-4)])
def test_relax_field_matches_reference_at_the_same_sweep(lattice, smoothness, tolerance):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    measured = rng.normal(0.0, 2.0, (*lattice, 3)).astype(np.float32)
    valid = rng.random(lattice) < 0.6
    init = np.broadcast_to(np.median(measured[valid], axis=0) if valid.any() else np.zeros(3),
                           measured.shape).astype(np.float32)
    kw = dict(smoothness=smoothness, tolerance=tolerance)
    got, sweeps = tflow._relax_field(torch.as_tensor(init), torch.as_tensor(measured), torch.as_tensor(valid),
                                     iterations=200, **kw)
    assert 0 < sweeps < 200
    args = (jnp.asarray(init), jnp.asarray(measured), jnp.asarray(valid))
    want = np.asarray(jflow._relax_field(*args, iterations=200, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the reference stopped at the port's sweep: capped there it gives the
    # same field, and one sweep short it does not
    np.testing.assert_array_equal(np.asarray(jflow._relax_field(*args, iterations=sweeps, **kw)), want)
    if sweeps > 1:
        short = np.asarray(jflow._relax_field(*args, iterations=sweeps - 1, **kw))
        assert np.abs(short - want).max() > 0


def test_compose_flow_fields_matches_reference():
    rng = np.random.default_rng(9)
    total = rng.normal(0.0, 2.0, (3, 3, 7, 7)).astype(np.float32)
    residual = rng.normal(0.0, 4.0, (3, 3, 7, 7)).astype(np.float32)  # reaches past the lattice
    stride = np.asarray((5.0, 16.0, 16.0))
    got = tflow._compose_flow_fields_same_grid(total, residual, stride)
    want = jflow._compose_flow_fields_same_grid(total, residual, stride)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- estimator
def _estimate_cases():
    """The five cases of tests/test_flow.py: (reference, moving, config
    keywords)."""
    ref = _bead_volume()
    cases = {"smooth": (ref, _warped(ref), dict(patch_size_zyx=(12, 24, 24), stride_zyx=(6, 12, 12),
                                              residual_iterations=2))}
    ref = _bead_volume(shape=(16, 64, 64), n=80, seed=3)
    cases["zero"] = (ref, ref.copy(), dict(patch_size_zyx=(8, 16, 16), stride_zyx=(4, 8, 8), residual_iterations=1))
    ref = _bead_volume(shape=(12, 64, 64), n=60, seed=7)
    moving = np.roll(ref, 2, axis=2)
    ref_m, mov_m = ref.copy(), moving.copy()
    ref_m[:, :, 32:] = 0.0
    mov_m[:, :, 32:] = 0.0
    cases["masked"] = (ref_m, mov_m, dict(patch_size_zyx=(8, 16, 16), stride_zyx=(4, 8, 8), residual_iterations=1,
                                          min_peak_ratio=0.5, min_peak_sharpness=0.0, max_masked=0.5))
    rng = np.random.default_rng(11)
    noise_ref = rng.normal(0, 1, (8, 32, 32)).astype(np.float32)
    noise_mov = rng.normal(0, 1, (8, 32, 32)).astype(np.float32)
    cases["sharpness-gate"] = (noise_ref, noise_mov, dict(patch_size_zyx=(8, 16, 16), stride_zyx=(4, 8, 8),
                                                          residual_iterations=1, min_peak_sharpness=4.5,
                                                          min_peak_ratio=1.0))
    ref = _bead_volume(shape=(16, 64, 64), n=60, seed=5)
    cases["store"] = (ref, _warped(ref, amp=(0.4, 1.5, 1.2)), dict(patch_size_zyx=(8, 16, 16), stride_zyx=(4, 8, 8),
                                                                 residual_iterations=1))
    return cases


@pytest.mark.parametrize("case", ["smooth", "zero", "masked", "sharpness-gate", "store"])
def test_estimator_matches_reference(case, tmp_path):
    ref, moving, kw = _estimate_cases()[case]
    jcfg, tcfg = _configs(**kw)
    want, want_meta = jflow.estimate_sofima_flow_field_xyz_px(ref, moving, jcfg)
    got, got_meta = tflow.estimate_sofima_flow_field_xyz_px(ref, moving, tcfg, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got_meta == want_meta
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL_PX)
    if case == "sharpness-gate":
        assert got_meta["valid_flow_vectors"] == 0 and got_meta["sofima_status"] == "no_valid_vectors"
    if case == "store":
        _store_round_trip(got, got_meta, moving, tmp_path)


def _store_round_trip(field, meta, moving, tmp_path):
    """The port's store keeps the field and the reference's attributes;
    the field from the reference's datastore warps equally."""
    from merfish3d_tpu.datastore import qi2labDataStore
    from merfish3d_tpu_torch.datastore.array_store import ArrayStore
    from merfish3d_tpu_torch.ops.warp import warp_affine_plus_flow

    ds = qi2labDataStore(tmp_path / "ds")
    ds.channels_in_data = ["a", "b", "c"]
    ds.num_tiles = 1
    ds.voxel_size_zyx_um = [0.3, 0.1, 0.1]
    ds.experiment_order = np.array([[1, 1, 2], [2, 3, 4]])
    ds.initialize_tile(0)
    ds.save_local_sofima_flow_field(field, tile=0, round=1, **meta)
    loaded = ds.load_local_sofima_flow_field(tile=0, round=1)
    store = ArrayStore.from_arrays(
        gene_ids=["g"], codebook_matrix=np.ones((1, 4)), voxel_size_zyx_um=(0.3, 0.1, 0.1),
        round_of_bit=[0, 0, 1, 1], bit_wavelengths_um=np.full((4, 2), 0.6), stage_positions_zyx_um=np.zeros(3),
        flow_fields={(0, 1): loaded},
    )
    version = store.flow_version
    store.save_local_sofima_flow_field(field, tile=0, round=2, **meta)
    assert store.flow_version == version + 1
    for key in ((0, 1), (0, 2)):
        got_field, attrs = store.load_local_sofima_flow_field(*key)
        np.testing.assert_array_equal(got_field, field)
        assert {k: attrs[k] for k in meta} == {k: loaded[1][k] for k in meta}
    kw = dict(transform_zyx_um=np.eye(4, dtype=np.float32), spacing_zyx_um=(1.0, 1.0, 1.0),
              reference_shape=moving.shape, device="cpu")
    a = warp_affine_plus_flow(moving, field, map_stride_zyx_px=meta["map_stride_zyx_px"],
                              map_box_start_xyz_px=meta["map_box_start_xyz_px"], **kw)
    b = warp_affine_plus_flow(moving, loaded[0], map_stride_zyx_px=loaded[1]["map_stride_zyx_px"],
                              map_box_start_xyz_px=loaded[1]["map_box_start_xyz_px"], **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
