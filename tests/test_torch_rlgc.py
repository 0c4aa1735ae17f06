"""The port's RLGC deconvolution (merfish3d_tpu_torch.ops.rlgc and its
kernels K4, K5, K9) against the JAX package, on CPU.

Each kernel's plain version (what the port runs on a CPU tensor, and what
the card's kernel is held to) is compared with the Pallas kernel it
replaces in interpret mode. Iterations are held to the reference exactly
by injecting the reference's own binomial splits through ``split_fn``;
whole solves, whose splits come from torch's generator, are held to it
statistically (the eight-seed comparison is in test_torch_rlgc_solves.py).
The hermetic decon case runs the port's own ``DataRegistration`` and is
held to the reference's F1 pin (cells: test_torch_decon_pin_cells.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_common import (
    DECON_PINS, F1_TOLERANCE, gaussian_psf, jax_solve, observed_counts, port_chain, solves_agree,
)

from merfish3d_tpu.ops import fftutils as jfft
from merfish3d_tpu.ops import mmfft as jmm
from merfish3d_tpu.ops import pfft as jpfft
from merfish3d_tpu.ops import rlgc as jrlgc
from merfish3d_tpu.ops import rlgc_kernels as jrk
from merfish3d_tpu_torch.ops import fftutils as tfft
from merfish3d_tpu_torch.ops import pfft as tpfft
from merfish3d_tpu_torch.ops import rlgc as trlgc
from merfish3d_tpu_torch.ops import rlgc_kernels as trk

DFT_TOL = 3e-5  # tests/test_pfft.py: f32 DFT sums in another order, x max|y|


def _t(a):
    return torch.as_tensor(np.asarray(a))


def reference_splits(observed: torch.Tensor, seed: int, iteration: int) -> torch.Tensor:
    """The reference's split1 of one iteration (threefry key folded with
    the iteration), as a port split_fn."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), iteration)
    counts = jnp.asarray(observed.numpy()).astype(jnp.int32)
    return torch.as_tensor(np.asarray(jrlgc._binomial_half(key, counts)))


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """The reference's TPU FFT dispatch (matmul FFT, Pallas kernels in
    interpret mode), forced through its module switches."""
    monkeypatch.setattr(jfft, "_FFT_IMPL", "matmul")
    monkeypatch.setattr(jmm, "_PFFT_ENV", "1")
    jax.clear_caches()
    with pltpu.force_tpu_interpret_mode():
        yield
    jax.clear_caches()


# ------------------------------------------------------ (a) sizing, padding
_LENGTHS = list(range(1, 200)) + [255, 256, 300, 500, 640, 1000, 1038, 1040, 1100, 1153,
                                  1500, 2000, 2062, 2100, 2500, 3000, 3072]


def test_fft_sizes_match_reference(monkeypatch):
    """Where the reference's TPU branch takes a Cooley-Tukey lane length,
    the port takes it too; everywhere else the port takes the reference's
    non-TPU 2,3-smooth cover. Exact."""
    lanes = 0
    for x in _LENGTHS:
        monkeypatch.setattr(jfft, "_FFT_IMPL", "matmul")
        tpu = jfft.next_smooth_fft_size(x)
        monkeypatch.setattr(jfft, "_FFT_IMPL", "xla")
        cpu = jfft.next_smooth_fft_size(x)
        want = tpu if tpfft.supported_ct_axis(tpu) else cpu
        lanes += tpfft.supported_ct_axis(tpu)
        assert tfft.next_smooth_fft_size(x) == want, x
        assert tfft._next_23_smooth(x) == jfft._next_23_smooth(x)
    assert lanes >= 10
    # the hermetic decon volume pads as in the reference's CPU tests, the
    # production tile as on the TPU
    assert tfft.linear_fft_pad_width((12, 96, 96), (15, 15, 15)) == \
        jfft.linear_fft_pad_width((12, 96, 96), (15, 15, 15))
    monkeypatch.setattr(jfft, "_FFT_IMPL", "matmul")
    pads = tfft.linear_fft_pad_width((16, 1024, 1024), (15, 15, 15))
    assert pads == jfft.linear_fft_pad_width((16, 1024, 1024), (15, 15, 15))
    assert tuple(n + b + a for n, (b, a) in zip((16, 1024, 1024), pads)) == (32, 1152, 1152)
    assert tfft.linear_fft_pad_width((8, 40, 40), (5, 7, 7), pad_yx=False)[1:] == ((0, 0), (0, 0))


@pytest.mark.parametrize(
    "shape,pad_width",
    [((4, 5, 6), ((2, 3), (1, 0), (0, 4))), ((3, 4, 2), ((7, 9), (5, 4), (0, 13)))],  # pads wider than the axis
)
def test_padding_helpers_match_reference(shape, pad_width):
    """pad_symmetric, remove_padding_zyx, enforce_symmetric_boundary and
    observed_region_mask equal the reference exactly; pad_psf within a few
    ulps (1e-6 relative) of its normalizing sum, taken in another order."""
    rng = np.random.default_rng(1)
    vol = rng.standard_normal(shape).astype(np.float32)
    padded = tfft.pad_symmetric(_t(vol), pad_width)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jfft.pad_symmetric(jnp.asarray(vol), pad_width)))
    np.testing.assert_array_equal(tfft.remove_padding_zyx(padded, pad_width).numpy(), vol)
    noisy = rng.standard_normal(tuple(padded.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        tfft.enforce_symmetric_boundary(_t(noisy), pad_width).numpy(),
        np.asarray(jfft.enforce_symmetric_boundary(jnp.asarray(noisy), pad_width)),
    )
    np.testing.assert_array_equal(tfft.observed_region_mask(padded.shape, pad_width).numpy(),
                                  jfft.observed_region_mask(tuple(padded.shape), pad_width))
    psf = gaussian_psf((5, 7, 3))
    for image_shape in ((8, 16, 12), (9, 15, 11)):
        np.testing.assert_allclose(tfft.pad_psf(psf, image_shape),
                                   np.asarray(jfft.pad_psf(jnp.asarray(psf), image_shape)),
                                   rtol=1e-6, atol=1e-12)


# -------------------------------------------------------------- (b) K9
@pytest.mark.parametrize(
    "shape",
    [(8, 256, 384), (32, 1152, 1152), (8, 2304, 128), (8, 2432, 128), (8, 256, 100), (4, 200, 256)],
)
def test_mid_conv_gate_matches_reference(shape):
    assert tpfft.mid_conv_supported(shape) == jpfft.mid_conv_supported(shape)


def test_k9_plain_matches_pallas():
    """K9's plain version (torch.fft along y, OTF product, inverse) against
    the Pallas dft_mid_conv in interpret mode, at (8, 256, 384)."""
    shape = (8, 256, 384)
    rng = np.random.default_rng(2)
    xr, xi, hr, hi = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        want = jpfft.dft_mid_conv(*(jnp.asarray(a) for a in (xr, xi, hr, hi)))
    got = tpfft.dft_mid_conv(_t(xr), _t(xi), _t(hr), _t(hi))
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DFT_TOL * scale)


# ----------------------------------------------------------- (c) K4, K5
_EW_SHAPE = (4, 8, 256)
_EW_PAD = ((1, 1), (2, 1), (3, 5))


def test_k4_plain_matches_pallas():
    """K4's plain version (the reference's generic chain) against the
    Pallas ratio_kld in interpret mode: ratios to an ulp (the same
    division), KLDs within 2e-4 relative (the reference's own bound
    between its decomposed and generic KLD, tests/test_rlgc.py)."""
    rng = np.random.default_rng(3)
    hu = rng.normal(5.0, 3.0, _EW_SHAPE).astype(np.float32)  # some < 0
    s1 = rng.poisson(4.0, _EW_SHAPE).astype(np.float32)
    s2 = rng.poisson(4.0, _EW_SHAPE).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        r1, r2, (k1, k2) = jrk.ratio_kld(jnp.asarray(hu), jnp.asarray(s1), jnp.asarray(s2), _EW_PAD)
    g1, g2, (gk1, gk2) = trk.ratio_kld(_t(hu), _t(s1), _t(s2), _EW_PAD)
    np.testing.assert_allclose(g1.numpy(), np.asarray(r1), rtol=1.2e-7)
    np.testing.assert_allclose(g2.numpy(), np.asarray(r2), rtol=1.2e-7)
    np.testing.assert_allclose(float(gk1), float(k1), rtol=2e-4)
    np.testing.assert_allclose(float(gk2), float(k2), rtol=2e-4)
    assert trk.fused_elementwise_supported(_EW_SHAPE) == jrk.fused_elementwise_supported(_EW_SHAPE)
    for shape in ((27, 128, 128), (32, 1152, 1152), (3, 3, 128), (4, 8, 200), (8, 8)):
        assert trk.fused_elementwise_supported(shape) == jrk.fused_elementwise_supported(shape)


@pytest.mark.parametrize("restore", [False, True])
def test_k5_plain_matches_pallas(restore):
    """K5's plain version against the Pallas update_select in interpret
    mode, both restore flags: selects exact, the count exact (an integer
    here, f32 there), maxima exact."""
    rng = np.random.default_rng(5)
    cons = rng.normal(0.0, 1.0, _EW_SHAPE).astype(np.float32)
    rec = rng.uniform(0.5, 2.0, _EW_SHAPE).astype(np.float32)
    prev = rng.uniform(0.5, 2.0, _EW_SHAPE).astype(np.float32)
    ht = rng.uniform(0.2, 1.8, _EW_SHAPE).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jrk.update_select(jnp.asarray(cons), jnp.asarray(rec), jnp.asarray(prev),
                                 jnp.asarray(ht), jnp.asarray(restore), _EW_PAD)
    got = trk.update_select(_t(cons), _t(rec), _t(prev), _t(ht), torch.tensor(restore), _EW_PAD)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2].dtype == torch.int64 and int(got[2]) == int(float(want[2]))
    assert float(got[3]) == float(want[3]) and float(got[4]) == float(want[4])


# ---------------------------------------------------- (d) convolutions
@pytest.mark.parametrize(
    "shape",
    [(8, 256, 384),  # K10 forward, K9, K10 inverse
     (27, 128, 128)],  # the hermetic decon volume: K8 on z, torch.fft on y and x
)
def test_fft_conv_matches_reference(tpu_dispatch, shape):
    """fft_conv_spec (a complex pair) and fft_conv_full (a real volume),
    each package with its own OTF in its own spectrum order, against the
    reference's TPU dispatch within the DFT tolerance of the output."""
    rng = np.random.default_rng(6)
    xr, xi = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    psf = tfft.pad_psf(gaussian_psf((5, 7, 7)), shape)
    otf_t = tfft.fftn_spec(_t(psf))
    otf_j = jfft.fftn_spec(jnp.asarray(psf))
    if shape == (8, 256, 384):
        assert tpfft.zx_supported(shape) and tpfft.mid_conv_supported(shape)
    want = jfft.fft_conv_spec(jnp.asarray(xr), jnp.asarray(xi), otf_j)
    got = tfft.fft_conv_spec(_t(xr), _t(xi), otf_t)
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DFT_TOL * scale)
    want = np.asarray(jfft.fft_conv_full(jnp.asarray(xr), otf_j))
    got = tfft.fft_conv_full(_t(xr), otf_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DFT_TOL * np.abs(want).max())


# ------------------------------------------------ (e) iterations, exactly
@pytest.mark.parametrize("iters", [1, 3])
def test_iterations_with_reference_splits_match_jax(iters):
    """k iterations with the reference's own splits injected: the port's
    plain path against JAX rlgc on CPU, within 1e-4 x max (torch.fft and
    XLA's FFT sum in other orders; the iterations multiply their
    rounding)."""
    obs = observed_counts()
    psf = gaussian_psf()
    want = jrlgc.rlgc(obs, psf, seed=4, max_iters=iters)
    got = trlgc.rlgc(obs, psf, seed=4, max_iters=iters, device="cpu", split_fn=reference_splits)
    assert got.shape == obs.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert not np.allclose(got, obs.mean(), rtol=1e-3)  # the solve moved off its flat start


def test_diagnostics_with_reference_splits_match_jax(caplog):
    """rlgc_diagnostics, its own stopping rule and log records included."""
    import logging

    obs = observed_counts((8, 32, 32), n=4, seed=1)
    psf = gaussian_psf((5, 7, 7))
    want = jrlgc.rlgc_diagnostics(obs, psf, seed=9, max_iters=6)
    with caplog.at_level(logging.INFO, logger="merfish3d_tpu_torch.rlgc"):
        got = trlgc.rlgc_diagnostics(obs, psf, seed=9, max_iters=6, device="cpu",
                                     split_fn=reference_splits)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert any("iteration=" in r.message for r in caplog.records)


# ------------------------------------------------ (f) solves, statistically
def test_rlgc_batch_statistically_matches_jax():
    obs = np.stack([observed_counts(seed=s) for s in range(3, 9)])
    psf = gaussian_psf()
    want = jrlgc.rlgc_batch(obs, psf, seed=10, max_iters=15)
    got, iters = trlgc.rlgc_batch(obs, psf, seed=10, max_iters=15, device="cpu", return_iters=True)
    assert got.shape == obs.shape and got.dtype == np.float32
    solves_agree(list(zip(got, iters)),
                  [(want[i], jax_solve(obs[i], psf, 10 + i, 15)[1]) for i in range(len(obs))])


# ------------------------------------------------------ (g) pairing
def test_paired_solve_matches_unpaired():
    """The paired retire-and-reload solve against one single-volume solve
    a volume, seeded as the batch seeds it, odd batch included: the same
    iteration counts, recons within the reference's own pair tolerance
    (rtol 1e-4, atol 1e-3: the packed convolution rounds differently)."""
    obs = np.stack([observed_counts(seed=s, background=5.0) for s in range(3)])
    psf = gaussian_psf()
    kw = dict(max_iters=12, device="cpu", return_iters=True)
    paired, it_p = trlgc.rlgc_batch(obs, psf, seed=7, **kw)
    singles = [trlgc.rlgc(v, psf, seed=7 + i, **kw) for i, v in enumerate(obs)]
    assert it_p == [n for _, n in singles]
    np.testing.assert_allclose(paired, np.stack([r for r, _ in singles]), rtol=1e-4, atol=1e-3)


def test_no_iteration_returns_the_flat_start():
    """``max_iters=0``: every volume, single or batched, retires as it
    loads, at its flat interior mean with 0 iterations (the reference's
    loop takes no step either)."""
    obs = np.stack([observed_counts(seed=s, background=5.0) for s in range(3)])
    psf = gaussian_psf()
    single, n = trlgc.rlgc(obs[0], psf, max_iters=0, device="cpu", return_iters=True)
    batch, iters = trlgc.rlgc_batch(obs, psf, max_iters=0, device="cpu", return_iters=True)
    assert n == 0 and iters == [0, 0, 0]
    np.testing.assert_array_equal(batch[0], single)
    for got, vol in zip(batch, obs):
        np.testing.assert_allclose(got, np.full(vol.shape, vol.mean()), rtol=1e-5)


# ------------------------------------------------ (h) tiling and budgets
def test_chunked_rlgc_covers_image():
    obs = observed_counts((8, 64, 64), n=10, seed=4)
    psf = gaussian_psf((5, 7, 7))
    whole = trlgc.rlgc(obs, psf, seed=5, max_iters=10, device="cpu")
    tiled = trlgc.chunked_rlgc(obs, psf, crop_yx=32, seed=5, max_iters=10, device="cpu")
    assert tiled.shape == obs.shape and np.all(np.isfinite(tiled))
    assert np.corrcoef(whole.ravel(), tiled.ravel())[0, 1] > 0.95
    untiled = trlgc.chunked_rlgc(obs, psf, crop_yx=64, seed=5, max_iters=10, device="cpu")
    np.testing.assert_array_equal(untiled, whole)


def test_budgets_and_bounds_match_reference(monkeypatch):
    """The reference's batch and crop arithmetic: equal on the production
    geometry under its TPU sizing, and equal everywhere once it is given
    the port's padding (which differs on axes that take no lane)."""
    for length, crop in ((100, 32), (64, 64), (2048, 1024), (1000, 300), (7, 3)):
        assert trlgc._axis_retained_bounds(length, crop) == jrlgc._axis_retained_bounds(length, crop)
    monkeypatch.setattr(jfft, "_FFT_IMPL", "matmul")
    for shape in ((16, 1024, 1024), (32, 1024, 1024)):
        assert trlgc.max_vmap_batch(shape, (15, 15, 15)) == jrlgc.max_vmap_batch(shape, (15, 15, 15))
        assert trlgc.auto_crop_yx(shape, (15, 15, 15)) == jrlgc.auto_crop_yx(shape, (15, 15, 15))
    assert trlgc.max_vmap_batch((16, 1024, 1024), (15, 15, 15)) == 17
    monkeypatch.setattr(jrlgc, "axis_linear_fft_padding", tfft.axis_linear_fft_padding)
    for shape, psf_shape in (((12, 96, 96), (15, 15, 15)), ((48, 2048, 2048), (9, 15, 15)),
                             ((32, 1024, 1024), (9, 15, 15))):
        for budget in (None, 1.4e8):
            assert trlgc.max_vmap_batch(shape, psf_shape, budget) == \
                jrlgc.max_vmap_batch(shape, psf_shape, budget)
        assert trlgc.auto_crop_yx(shape, psf_shape) == jrlgc.auto_crop_yx(shape, psf_shape)


def test_binomial_split_distribution():
    """The split sampler: popcount exact below 33 counts (integers in
    [0, n]), normal approximation beyond; mean n/2 and variance n/4."""
    v = torch.as_tensor(np.random.default_rng(8).integers(0, 2**32, 1000), dtype=torch.int64)
    assert trlgc._popcount32(v).tolist() == [bin(int(a)).count("1") for a in v]
    for n in (0, 1, 7, 32, 33, 400):
        counts = torch.full((200_000,), float(n))
        s = trlgc.binomial_split(counts, 3, 0)
        assert torch.all((s >= 0) & (s <= n)) and torch.all(s == torch.round(s))
        assert abs(s.mean().item() - n / 2) < 0.02 * n + 0.01
        assert abs(s.var().item() - n / 4) < 0.03 * n + 0.01
    again = trlgc.binomial_split(torch.full((1000,), 50.0), 3, 1)
    assert torch.equal(again, trlgc.binomial_split(torch.full((1000,), 50.0), 3, 1))
    assert not torch.equal(again, trlgc.binomial_split(torch.full((1000,), 50.0), 3, 2))
    assert trlgc.kl_div(np.ones(8), np.ones(8)) == pytest.approx(jrlgc.kl_div(np.ones(8), np.ones(8)))


# ---------------------------------------------- (i) the hermetic decon cases
@pytest.mark.parametrize("distribution", ["uniform"])  # cells: test_torch_decon_pin_cells.py
def test_hermetic_decon_f1_meets_pin(distribution):
    """The port's own chain with RLGC on the readout bits (12 iterations,
    no fiducial decon, as tests/f1_matrix_common.py runs the decon cases)
    on CPU: F1 within ±0.02 of the reference's pin."""
    store, f1 = port_chain(distribution, True)
    assert not np.array_equal(store.registered[(0, 0)], store.corrected[(0, 0)])
    assert abs(f1 - DECON_PINS[distribution]) <= F1_TOLERANCE, f1


def test_fiducial_decon_registers_rounds():
    """decon_fiducial deconvolves the reference round (stored as u16) and
    the moving rounds in batches before registering them: the hermetic
    rounds image one bead field, so every transform stays within 0.3 px
    of the identity."""
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    raw = generate_raw_experiment(shape=(12, 96, 96), n_spots=40, seed=11)
    store = convert_data(raw)
    reg = DataRegistration(store, device="cpu", decon_fiducial=True, decon_readout=False,
                           decon_max_iters=4, round_batch_size=3)
    reg._generate_registrations(0)
    ref = store.fiducial_registered[(0, 0)]
    assert ref.dtype == np.uint16 and not np.array_equal(ref, raw.fiducial[0, 0])
    spacing = np.asarray(raw.voxel_size_zyx_um)
    for r in range(raw.fiducial.shape[1]):
        assert np.abs(store.round_transforms[(0, r)][:3, 3] / spacing).max() <= 0.3
