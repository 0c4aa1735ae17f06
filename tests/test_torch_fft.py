"""The port's DFT layer (merfish3d_tpu_torch.ops.pfft, .fftutils) against
the JAX package, on CPU.

Each kernel's plain version (what the port runs on a CPU tensor, and what
the card's kernel is held to) is compared with the Pallas kernel it
replaces, run in interpret mode as tests/test_pfft.py runs it, within the
reference's own DFT tolerance: 3e-5 x max|X|. The spectrum-order tests
force the reference's TPU dispatch (matmul FFT + Pallas kernels) through
its module switches with monkeypatch, so the port's scrambled order is
checked against the TPU's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merfish3d_tpu.ops import fftutils as jfft
from merfish3d_tpu.ops import mmfft as jmm
from merfish3d_tpu.ops import pfft as jpfft
from merfish3d_tpu_torch.ops import fftutils as tfft
from merfish3d_tpu_torch.ops import pfft as tpfft

SHAPE = (8, 256, 384)  # z dense, y = 2*128, x = 3*128
TOL = 3e-5  # tests/test_pfft.py: f32 DFT sums in another order


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL * scale)


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


# name → (input shape, JAX kernel)
_KERNELS = {
    "dft_trailing": ((SHAPE[0] * SHAPE[1], SHAPE[2]), jpfft.dft_trailing),
    "dft_middle": (SHAPE, jpfft.dft_middle),
    "dft_leading": (SHAPE, jpfft.dft_leading),
    "dft_zx": (SHAPE, jpfft.dft_zx),
}


@pytest.mark.parametrize("complex_in", [False, True])
@pytest.mark.parametrize("name", list(_KERNELS))
def test_plain_forward_matches_pallas(name, complex_in):
    shape, jax_fn = _KERNELS[name]
    xr, xi = _pair(shape)
    xi = xi if complex_in else None
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(jnp.asarray(xr), None if xi is None else jnp.asarray(xi))
    got = getattr(tpfft, name)(_t(xr), _t(xi))
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want):
        _close(g, w, scale)


@pytest.mark.parametrize("real_output", [False, True])
@pytest.mark.parametrize("name", list(_KERNELS))
def test_plain_inverse_matches_pallas(name, real_output):
    shape, jax_fn = _KERNELS[name]
    sr, si = _pair(shape, seed=1)  # a complex spectrum in the kernels' order
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(jnp.asarray(sr), jnp.asarray(si), inverse=True, real_output=real_output)
    got = getattr(tpfft, name)(_t(sr), _t(si), inverse=True, real_output=real_output)
    assert (got[1] is None) == (want[1] is None) == real_output
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], scale)
    if got[1] is not None:
        _close(got[1], want[1], scale)


def test_dft_axis_3d_matches_pallas():
    xr, xi = _pair(SHAPE, seed=2)
    for axis in range(3):
        with pltpu.force_tpu_interpret_mode():
            want = jpfft.dft_axis_3d(jnp.asarray(xr), jnp.asarray(xi), axis)
        got = tpfft.dft_axis_3d(_t(xr), _t(xi), axis)
        scale = float(np.abs(np.asarray(want[0])).max())
        for g, w in zip(got, want):
            _close(g, w, scale)


_GRID = [
    (8, 256, 384), (16, 896, 896), (32, 1920, 1920), (12, 48, 48), (16, 128, 128),
    (73, 8, 768), (74, 8, 768), (18, 8, 3072), (19, 8, 3072), (96, 8, 512), (97, 8, 512),
    (1, 256, 256), (2, 256, 256), (8, 260, 384), (8, 256, 100), (7, 255, 256),
    (40, 1152, 1152), (16, 1024, 1024), (96, 16, 3200), (8, 3328, 384), (8, 2, 3072),
]


@pytest.mark.parametrize("shape", _GRID)
def test_predicates_match_reference(shape):
    assert tpfft.zx_supported(shape) == jpfft.zx_supported(shape)
    for axis in range(3):
        assert tpfft.axis_supported(shape, axis) == jpfft.axis_supported(shape, axis)
    for n in shape:
        assert tpfft.supported_ct_axis(n) == jpfft.supported_ct_axis(n)
        assert tpfft.supported_dense_axis(n) == jpfft.supported_dense_axis(n)


def test_constants_and_scramble_match_reference():
    for n in (256, 896, 1920, 3072):
        for inverse in (False, True):
            port = tpfft._consts_ct(n, inverse)
            assert len(port) == 2  # w1 and the twiddle; no kernel reads a dense w2 table
            for a, b in zip(port, jpfft._consts_ct(n, inverse)[:2]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tpfft.scramble_perm(n), jmm.scramble_perm(n))
        assert tpfft.fft_axis_split(n) == jmm.fft_axis_split(n)
    for n in (2, 12, 96):
        np.testing.assert_array_equal(tpfft._consts_dense(n, True), jpfft._consts_dense(n, True))
        np.testing.assert_array_equal(tpfft.scramble_perm(n), jmm.scramble_perm(n))


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


@pytest.mark.parametrize(
    "shape",
    [
        SHAPE,  # K10 + K7
        (96, 8, 768),  # past zx's byte gate: K6, y = 8 dense outside Pallas, K8
        (256, 384),  # 2D: the stage-1 projection's path, outside Pallas
    ],
)
def test_spectrum_order_matches_tpu_dispatch(tpu_dispatch, shape):
    xr, xi = _pair(shape, seed=3)
    assert jfft.use_matmul_fft()
    want = jfft.fftn_spec(jnp.asarray(xr))
    got = tfft.fftn_spec(_t(xr))
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want):
        _close(g, w, scale)
    want_inv = jfft.ifftn_spec(jnp.asarray(xr), jnp.asarray(xi))
    got_inv = tfft.ifftn_spec(_t(xr), _t(xi))
    scale = float(np.abs(np.asarray(want_inv[0])).max())
    for g, w in zip(got_inv, want_inv):
        _close(g, w, scale)
    real_only = tfft.ifftn_spec(_t(xr), _t(xi), real_output=True)
    assert real_only[1] is None
    _close(real_only[0], want_inv[0], scale)
    for n in shape:
        np.testing.assert_array_equal(tfft.spectrum_freqs(n), jfft.spectrum_freqs(n))


def test_per_axis_route_matches_reference_layout():
    """A volume past K10's byte gate with y = 2*128 takes K6, K7 and K8 in
    turn (the camera frame's route). Its spectrum is the natural DFT
    permuted along each axis by the reference's own layout
    (``mmfft.scramble_perm``), and its inverses return the input. (The
    TPU dispatch in interpret mode takes over 30 s at any such shape.)"""
    shape = (96, 256, 640)
    assert not tpfft.zx_supported(shape) and not jpfft.zx_supported(shape)
    assert all(tpfft.axis_supported(shape, ax) for ax in range(3))
    xr, xi = _pair(shape, seed=6)
    want = np.fft.fftn(xr.astype(np.float64))
    for ax, n in enumerate(shape):
        want = np.take(want, jmm.scramble_perm(n), axis=ax)
    got = tfft.fftn_spec(_t(xr))
    _close(got[0], want.real, np.abs(want).max())
    _close(got[1], want.imag, np.abs(want).max())
    back = tfft.ifftn_spec(*got)
    _close(back[0], xr, np.abs(xr).max())
    _close(back[1], np.zeros_like(xr), np.abs(xr).max())
    real_only = tfft.ifftn_spec(*got, real_output=True)
    assert real_only[1] is None
    _close(real_only[0], xr, np.abs(xr).max())


def test_roundtrip_and_natural_pairs():
    xr, xi = _pair((16, 128, 256), seed=4)
    fr, fi = tfft.fftn_spec(_t(xr), _t(xi))
    yr, yi = tfft.ifftn_spec(fr, fi)
    np.testing.assert_allclose(yr.numpy(), xr, atol=2e-5 * np.abs(xr).max())
    np.testing.assert_allclose(yi.numpy(), xi, atol=2e-5 * np.abs(xi).max())
    want = np.fft.fftn(xr + 1j * xi)
    got = tfft.fftn_pair(_t(xr), _t(xi))
    _close(got[0], want.real, np.abs(want).max())
    _close(got[1], want.imag, np.abs(want).max())
    back = tfft.ifftn_pair(*got)
    np.testing.assert_allclose(back[0].numpy(), xr, atol=2e-5 * np.abs(xr).max())


# ---------------- the radix factorizations of K6, K7, K8, K9 and K10, modelled
# A numpy model of csrc/pfft.cu's dft_zx_x (K6, K10's x pass), dft_zx_z
# (K10's z pass, K8's dense route), dft_middle_a / dft_middle_b (K7),
# dft_mid_conv_b (K9), dft_lead_radix (K8) and csrc/fft128.cuh, index for
# index and driven by the tables the wrappers upload (tpfft.ct_tables,
# tpfft.zx_tables, tpfft.dense_z_table, tpfft.lead_radix_table), so an
# index or table error in the design shows on CPU. Its butterfly constants
# are the header's.
_R2, _C8, _S8 = np.float32(0.70710678118654752), np.float32(0.92387953251128676), \
    np.float32(0.38268343236508977)


def _rot(a, c, s, inv):
    """a * exp(-+iθ) given (cos θ, sin θ): fft128::rot."""
    return a * complex(c, s if inv else -s)


def _mul_i(a, inv):
    return a * (1j if inv else -1j)


def _dft4(a0, a1, a2, a3, inv):
    s02, d02 = a0 + a2, a0 - a2
    s13, d13 = a1 + a3, _mul_i(a1 - a3, inv)
    return s02 + s13, d02 + d13, s02 - s13, d02 - d13


def _dft8(v, inv):
    """fft128::dft8 on v[..., 0:8]: n = 2a + e, k = c + 4d."""
    u = _dft4(v[..., 0], v[..., 2], v[..., 4], v[..., 6], inv)
    w = list(_dft4(v[..., 1], v[..., 3], v[..., 5], v[..., 7], inv))
    w[1] = _rot(w[1], _R2, _R2, inv)
    w[2] = _mul_i(w[2], inv)
    w[3] = _rot(w[3], -_R2, _R2, inv)
    return np.stack([u[c] + w[c] for c in range(4)] + [u[c] - w[c] for c in range(4)], axis=-1)


def _dft16(v, inv):
    """fft128::dft16 on v[..., 0:16]: n = 4a + b, k = c + 4d."""
    u = np.empty_like(v)
    for b in range(4):
        u[..., b::4] = np.stack(_dft4(*(v[..., 4 * a + b] for a in range(4)), inv), axis=-1)
    # U[b][c] at u[4c + b], times W16^(bc)
    consts = {1: (_C8, _S8), 2: (_R2, _R2), 3: (_S8, _C8), 6: (-_R2, _R2), 9: (-_C8, -_S8)}
    for b in range(1, 4):
        for c in range(1, 4):
            e = b * c
            u[..., 4 * c + b] = _mul_i(u[..., 4 * c + b], inv) if e == 4 else \
                _rot(u[..., 4 * c + b], *consts[e], inv)
    out = np.empty_like(v)
    for c in range(4):
        y = _dft4(*(u[..., 4 * c + b] for b in range(4)), inv)
        for d in range(4):
            out[..., c + 4 * d] = y[d]
    return out


def _fft128_model(C, w128, inv):
    """fft128::transform on C[..., 0:128]: thread b holds x[8a + b]; the
    16-point DFT over a, the twiddle w128[b*k1], then for each k1 the
    8-point DFT over b gives X[k1 + 16*k2]."""
    v = C.reshape(*C.shape[:-1], 16, 8).swapaxes(-1, -2)  # [..., b, a]
    y = _dft16(v, inv)  # [..., b, k1]
    b, k1 = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    y = y * w128[b * k1].astype(np.complex128)
    x = _dft8(y.swapaxes(-1, -2), inv)  # [..., k1, k2]
    return x.swapaxes(-1, -2).reshape(C.shape)  # position k1 + 16*k2


def _c128(tables):
    """The uploaded tables in double precision, except W128 (the model
    multiplies by its complex64 entries, as the kernel does)."""
    return tuple(t.astype(np.complex128) if t.ndim > 1 else t for t in tables)


def _rows_model(x, tables, inverse):
    """The x pass (dft_zx_x: K6, K10's x pass) on the last axis: forward
    stage 1 with w1 and the twiddle, then the 128-point FFTs (scrambled
    out); inverse the FFTs, the twiddle, the n1-point synthesis."""
    w1, tw, w128 = _c128(tables)
    *lead, n = x.shape
    x = x.reshape(*lead, n // 128, 128)
    if not inverse:
        c = np.einsum("...pq,kp->...kq", x, w1) * tw
        return _fft128_model(c, w128, False).reshape(*lead, n)
    e = _fft128_model(x, w128, True) * tw
    return np.einsum("...kq,kp->...pq", e, w1).reshape(*lead, n)


def _dft_zx_model(x, inverse):
    """K10 as the two launches run it: forward x pass then the dense z
    pass, which reads the symmetric z table by rows (W[j][k] for output
    k); inverse the z pass, then the x pass."""
    nz, ny, n = x.shape
    *tables, wz = tpfft.zx_tables(nz, n, inverse)
    assert wz.shape == (nz, -(-nz // 8) * 8) and not wz[:, nz:].any()
    wz = wz[:, :nz].astype(np.complex128)
    if not inverse:
        return np.einsum("jk,jyx->kyx", wz, _rows_model(x, tables, False))
    return _rows_model(np.einsum("jk,jyx->kyx", wz, x), tables, True)


@pytest.mark.parametrize("nz", [16, 27, 32])
@pytest.mark.parametrize("n1", [2, 7, 9, 24])
def test_k10_factorization_model_matches_plain(n1, nz):
    """The model, forward (scrambled x out) and inverse (natural out), at
    the plain dft_zx within 1e-5 x max|X|: the radix FFT is held to a
    tighter limit than the card's 3e-5."""
    xr, xi = _pair((nz, 2, 128 * n1), seed=n1 * 100 + nz)
    want = tpfft.dft_zx_plain(_t(xr), _t(xi))
    got = _dft_zx_model(xr.astype(np.float64) + 1j * xi, False)
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    np.testing.assert_allclose(got.real, want[0].numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.imag, want[1].numpy(), rtol=0, atol=1e-5 * scale)
    back = tpfft.dft_zx_plain(_t(xr), _t(xi), inverse=True)
    got = _dft_zx_model(xr.astype(np.float64) + 1j * xi, True)
    scale = max(float(back[0].abs().max()), float(back[1].abs().max()))
    np.testing.assert_allclose(got.real, back[0].numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.imag, back[1].numpy(), rtol=0, atol=1e-5 * scale)


def _pair_model_check(got, want):
    """The model within 1e-5 x max|X| of a plain (yr, yi): the radix FFT is
    held to a tighter limit than the card's 3e-5."""
    scale = max(float(w.abs().max()) for w in want if w is not None)
    np.testing.assert_allclose(got.real, want[0].numpy(), rtol=0, atol=1e-5 * scale)
    if want[1] is not None:
        np.testing.assert_allclose(got.imag, want[1].numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n1", [2, 15, 17, 24])
def test_k6_rows_model_matches_plain(n1, real):
    """K6 is one launch of the x pass: the model, forward (real input when
    ``real``) and inverse (real output when ``real``), at dft_trailing_plain."""
    n = 128 * n1
    xr, xi = _pair((3, n), seed=n1 * 10 + real)
    fwd_in = xr.astype(np.float64) + (0 if real else 1j * xi)
    want = tpfft.dft_trailing_plain(_t(xr), None if real else _t(xi))
    _pair_model_check(_rows_model(fwd_in, tpfft.ct_tables(n, False), False), want)
    back = tpfft.dft_trailing_plain(_t(xr), _t(xi), inverse=True, real_output=real)
    assert (back[1] is None) == real
    got = _rows_model(xr.astype(np.float64) + 1j * xi, tpfft.ct_tables(n, True), True)
    _pair_model_check(got, back)


def _mid_b_columns():
    """mid_group_tile's map: the tile column whose 128-point FFT the 8 lanes
    of group g (of 4) of warp w (of 8) run, as an (8, 4) array."""
    warp, g = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    pair = 2 * warp + (g >> 1)
    return (pair & 7) + 16 * (pair >> 3) + 8 * (g & 1)


def _mid_pass_a(x, w1, tw, inverse):
    """dft_middle_a on (nz, n1, 128, nx): the n1-point stage of every
    (z, q, x) column; forward with the twiddle."""
    if not inverse:
        return np.einsum("zpqx,kp->zkqx", x, w1) * tw[None, :, :, None]
    return np.einsum("zkqx,kp->zpqx", x, w1)


def _mid_stage(y, x0):
    """mid_stage: the 32-column tile at x0 of every (z, group k), staged
    transposed as (nz, n1, column, q)."""
    return y[..., x0:x0 + 32].swapaxes(-1, -2)


def _mid_transform(S, w128, inverse):
    """mid_transform: the FFT of tile column c run by the lanes the map
    gives it; every column the map misses stays NaN."""
    cols = _mid_b_columns().ravel()
    T = np.full_like(S, np.nan)
    T[..., cols, :] = _fft128_model(S[..., cols, :], w128, inverse)
    return T


def _mid_tiles(y, step):
    """A pass-B launch over (nz, n1, 128, nx): ``step(staged tile, x0)``
    on each 32-column tile, stored back (mid_store's layout)."""
    out = np.full_like(y, np.nan)
    for x0 in range(0, y.shape[-1], 32):
        out[..., x0:x0 + 32] = step(_mid_stage(y, x0), x0).swapaxes(-1, -2)
    return out


def _mid_pass_b(y, w128, tw, inverse):
    """dft_middle_b: stage, transform, and the twiddle on the way out for
    the inverse."""
    def step(S, x0):
        T = _mid_transform(S, w128, inverse)
        return T * tw[None, :, None, :] if inverse else T

    return _mid_tiles(y, step)


def _mid_conv_pass_b(y, h, w128f, w128i, twi):
    """dft_mid_conv_b: stage, forward transform, the product with the OTF
    staged from the same (z, k*128 + m, x) coordinates, inverse transform,
    the inverse twiddle on the way out."""
    def step(S, x0):
        T = _mid_transform(S, w128f, False) * _mid_stage(h, x0)
        return _mid_transform(T, w128i, True) * twi[None, :, None, :]

    return _mid_tiles(y, step)


def _dft_middle_model(x, inverse):
    """K7 as its two launches run it along axis 1 of (nz, n, nx): forward
    pass A then pass B in place; inverse pass B then pass A in place."""
    nz, n, nx = x.shape
    w1, tw, w128 = _c128(tpfft.ct_tables(n, inverse))
    x = x.reshape(nz, n // 128, 128, nx)
    if not inverse:
        y = _mid_pass_b(_mid_pass_a(x, w1, tw, False), w128, tw, False)
    else:
        y = _mid_pass_a(_mid_pass_b(x, w128, tw, True), w1, tw, True)
    return y.reshape(nz, n, nx)


@pytest.mark.parametrize("n1", [2, 7, 17, 24])
def test_k7_passes_model_matches_plain(n1):
    """The model of K7's passes, forward (scrambled y out) and inverse
    (natural out), at dft_middle_plain within 1e-5 x max|X|."""
    xr, xi = _pair((2, 128 * n1, 64), seed=n1)
    x = xr.astype(np.float64) + 1j * xi
    _pair_model_check(_dft_middle_model(x, False), tpfft.dft_middle_plain(_t(xr), _t(xi)))
    _pair_model_check(_dft_middle_model(x, True),
                      tpfft.dft_middle_plain(_t(xr), _t(xi), inverse=True))


def _dft_mid_conv_model(x, h):
    """K9 as its three launches run it along axis 1 of (nz, n, nx): K7's
    pass A forward, the conv pass in place, pass A inverse in place."""
    nz, n, nx = x.shape
    w1f, twf, w128f = _c128(tpfft.ct_tables(n, False))
    w1i, twi, w128i = _c128(tpfft.ct_tables(n, True))
    grouped = (nz, n // 128, 128, nx)
    y = _mid_pass_a(x.reshape(grouped), w1f, twf, False)
    y = _mid_conv_pass_b(y, h.reshape(grouped), w128f, w128i, twi)
    return _mid_pass_a(y, w1i, twi, True).reshape(nz, n, nx)


@pytest.mark.parametrize("n1", [2, 9, 17, 24])
def test_k9_passes_model_matches_plain(n1):
    """The model of K9's three passes, the OTF product at the scrambled
    coordinates of the forward spectrum, at dft_mid_conv_plain within
    1e-5 x max|y|."""
    xr, xi = _pair((2, 128 * n1, 64), seed=300 + n1)
    hr, hi = _pair((2, 128 * n1, 64), seed=400 + n1)
    got = _dft_mid_conv_model(xr.astype(np.float64) + 1j * xi, hr.astype(np.float64) + 1j * hi)
    assert np.isfinite(got).all()
    _pair_model_check(got, tpfft.dft_mid_conv_plain(_t(xr), _t(xi), _t(hr), _t(hi)))


def _lead_model(x, inverse):
    """K8 on axis 0 of (n, ...) by its route. Radix (dft_lead_radix):
    u[j1][j2] = x[R*j2 + j1]; the M-point DFT of each j1 (the header's
    butterflies), the twiddle tab[j1*M + k1], then X[k1 + M*k2] = sum_j1
    u[j1][k1] tab[R*M + j1*R + k2]. Dense (dft_zx_z): the z table read by
    rows, W[j][k] for output k."""
    x = x.astype(np.complex128)
    n = x.shape[0]
    if tpfft.leading_route(n) == "z":
        wz = tpfft.dense_z_table(n, inverse)
        assert wz.shape == (n, -(-n // 8) * 8) and not wz[:, n:].any()
        return np.einsum("jk,j...->k...", wz[:, :n].astype(np.complex128), x)
    r, m = tpfft.LEAD_RADIX[n]
    tab = tpfft.lead_radix_table(n, inverse).astype(np.complex128)
    assert tab.shape == (r * m + r * r,)
    tw, wr = tab[:r * m].reshape(r, m), tab[r * m:].reshape(r, r)
    u = np.moveaxis(x.reshape(m, r, -1), 0, -1)  # [j1, column, j2]
    u = (_dft8 if m == 8 else _dft16)(u, inverse) * tw[:, None, :]  # [j1, column, k1]
    return np.einsum("jck,jl->lkc", u, wr).reshape(x.shape)  # position k1 + M*k2


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", sorted(tpfft.LEAD_RADIX) + [2, 5, 12, 27, 80, 96])
def test_k8_model_matches_plain(n, real):
    """K8's model by route, forward (real input when ``real``) and inverse
    (real output when ``real``), at dft_leading_plain within 1e-5 x
    max|X|: every length of the radix route, and lengths of the z pass."""
    xr, xi = _pair((n, 3, 8), seed=500 + n)
    fwd_in = xr.astype(np.float64) + (0 if real else 1j * xi)
    want = tpfft.dft_leading_plain(_t(xr), None if real else _t(xi))
    _pair_model_check(_lead_model(fwd_in, False), want)
    back = tpfft.dft_leading_plain(_t(xr), _t(xi), inverse=True, real_output=real)
    assert (back[1] is None) == real
    _pair_model_check(_lead_model(xr.astype(np.float64) + 1j * xi, True), back)


def test_k8_route_map():
    """Every length K8 takes (2..96) goes to exactly one kernel, by the
    length alone: the radix route for n = R*M <= 64 with M in {8, 16} (the
    kernel's instantiations), the z pass for every other; the camera crop
    (32) and frame (48) take the radix route, and lengths outside 2..96
    are refused."""
    routes = {n: tpfft.leading_route(n) for n in range(2, 97)}
    assert set(routes.values()) == {"radix", "z"}
    assert {n for n, r in routes.items() if r == "radix"} == set(tpfft.LEAD_RADIX) == \
        {8, 16, 24, 32, 40, 48, 64}
    for n, (r, m) in tpfft.LEAD_RADIX.items():
        assert r * m == n and m in (8, 16) and 1 <= r <= 5
    assert routes[32] == routes[48] == "radix"
    for n in (0, 1, 97):
        with pytest.raises(ValueError):
            tpfft.leading_route(n)


def test_k7_pass_b_shared_memory_is_conflict_free():
    """Pass B's shared-memory addresses (a column every 129 float2), which
    K7's pass B and K9's conv pass share: the row-wise staging stores, K9's
    OTF product (the same row pattern) and the final loads, and
    fft128::transform's four access phases on the columns the map gives
    each group of 8 lanes. Every half-warp's 16 float2 accesses fall in 16
    distinct bank pairs (address mod 16), and the map covers each of the
    32 columns once."""
    gs = 129
    cols = _mid_b_columns()
    assert sorted(cols.ravel().tolist()) == list(range(32))
    lanes = np.arange(32)
    t = lanes & 7

    def conflict_free(addr):
        for h in (0, 16):
            assert len(set((addr[h:h + 16] % 16).tolist())) == 16, addr

    for r in range(128):  # stage, K9's product, store: lane = column, one row a warp access
        conflict_free(lanes * gs + r)
    for warp in range(8):
        base = cols[warp][lanes >> 3] * gs
        for a in range(16):  # loads x[8a + t]
            conflict_free(base + 8 * a + t)
        for k1 in range(16):  # exchange stores, XOR-swizzled
            conflict_free(base + 8 * k1 + (t ^ (k1 & 7)))
        for b in range(8):  # exchange loads of k1 = t and t + 8
            conflict_free(base + 8 * t + (b ^ t))
            conflict_free(base + 8 * (t + 8) + (b ^ t))
        for k2 in range(8):  # outputs X[k1 + 16 k2]
            conflict_free(base + t + 16 * k2)
            conflict_free(base + t + 8 + 16 * k2)
