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
            for a, b in zip(tpfft._consts_ct(n, inverse), jpfft._consts_ct(n, inverse)):
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
