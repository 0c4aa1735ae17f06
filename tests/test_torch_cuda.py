"""Hand-written CUDA kernels of merfish3d_tpu_torch against their plain
torch versions, on the card (decode K1-K3, DFT K6-K10, RLGC K4 and K5,
the U-FISH convolution K11), and the component labeller and sums against
the host's labeller and numpy sums.

Needs a CUDA device and nvcc; skips without them. Imports neither JAX
nor the JAX package, so it runs where those are absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from merfish3d_tpu_torch.ops import decode as dec
from merfish3d_tpu_torch.ops import fused_decode as fd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches():
    """``launches(kernel)``: the kernel's launches since the test began,
    from the port's tracing registry (on for the test's span)."""
    from merfish3d_tpu_torch.utils import profiling

    profiling.enable()
    profiling.reset()

    def read(kernel: str) -> int:
        return profiling.snapshot()["counters"].get("launch." + kernel, {}).get("total", 0)

    yield read
    profiling.enable(False)
    profiling.reset()


def _codebook(rng, words=24, bits=16):
    cb = np.zeros((words, bits), np.float32)
    for w in range(words):
        cb[w, rng.choice(bits, 4, replace=False)] = 1.0
    return cb


def _near_tie(sims, i, tol=1e-4):
    top2 = np.sort(sims[:, i])[::-1][:2]
    return top2[0] - top2[1] < tol


def test_k3_matches_plain(cuda):
    rng = np.random.default_rng(0)
    bits, n = 16, 70_001  # ragged last block
    cb = _codebook(rng)
    traces = torch.as_tensor((rng.random((bits, n)) * 2).astype(np.float32), device=cuda)
    cbt = torch.as_tensor(dec.normalize_codebook(cb).T.copy(), device=cuda)
    bg = torch.as_tensor((rng.random(bits) * 0.1).astype(np.float32), device=cuda)
    nm = torch.as_tensor((rng.random(bits) + 0.5).astype(np.float32), device=cuda)
    k = dec.decode_chunk_cuda(traces, cbt, bg, nm)
    p = dec.decode_chunk_plain(traces, cbt, bg, nm)
    torch.cuda.synchronize()
    # f32 FMA vs matmul summation order: a few ulp
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    diff = (k[0] != p[0]).cpu().numpy()
    unit = (p[3] / p[2].clamp(min=1e-12)).cpu().numpy()
    sims = cbt.T.cpu().numpy() @ unit
    assert all(_near_tie(sims, i) for i in np.flatnonzero(diff))
    no_scaled = dec.decode_chunk_cuda(traces, cbt, bg, nm, want_scaled=False)
    assert no_scaled[3] is None
    assert torch.equal(no_scaled[0], k[0])


# (bits, Z, Y, X) at the staged kernel's edges (segments of 32 rows up to 16
# planes, 16 up to 32, 8 up to 64; 32 columns a block): Y below a segment,
# Y 1, 3 and 5 against the 4-row halo, a ragged last segment, Z 1 and 64, X
# not a multiple of 4 (4-byte copies) and below one block, 32 bits; 70 planes
# take the direct kernel
_K1_SHAPES = [
    (16, 12, 40, 200), (16, 16, 33, 129), (4, 70, 24, 136), (16, 16, 20, 64),
    (16, 16, 1, 64), (3, 5, 3, 130), (2, 12, 5, 97), (4, 1, 40, 64), (2, 64, 37, 100),
    (2, 33, 19, 36), (32, 16, 70, 33), (2, 6, 96, 3),
]


@pytest.mark.parametrize("shape", _K1_SHAPES)
def test_k1_matches_plain(cuda, shape):
    rng = np.random.default_rng(1)
    vol = torch.as_tensor((rng.random(shape) * 100).astype(np.float32), device=cuda)
    out = fd.zy_lowpass_cuda(vol, (3.0, 1.0, 1.0))
    ref = fd.zy_lowpass_plain(vol, (3.0, 1.0, 1.0))
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * vol.abs().max().item()


# sigma (z, y): no z pass, the hermetic matrix's z, y taps past the register
# window (21 taps: read from shared memory), one y tap
@pytest.mark.parametrize("sigma", [(0.0, 1.0), (0.945, 1.0), (3.0, 2.6), (3.0, 0.0)])
@pytest.mark.parametrize("shape", [(16, 12, 40, 200), (2, 64, 9, 64)])
def test_k1_sigmas_match_plain(cuda, shape, sigma):
    rng = np.random.default_rng(5)
    vol = torch.as_tensor((rng.random(shape) * 100).astype(np.float32), device=cuda)
    out = fd.zy_lowpass_cuda(vol, sigma)
    ref = fd.zy_lowpass_plain(vol, sigma)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * vol.abs().max().item()


def test_k1_tables_built_once(cuda):
    """A second call on the same shape and sigma builds and uploads no table:
    the wrapper's cache answers it."""
    vol = torch.ones((2, 7, 23, 40), device=cuda)
    fd.zy_lowpass_cuda(vol, (3.0, 1.0, 1.0))
    before = fd._zy_tables.cache_info()
    out = fd.zy_lowpass_cuda(vol, (3.0, 1.0, 1.0))
    after = fd._zy_tables.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=1e-6, atol=0)


def test_k1_route(cuda):
    """The route the kernel library reports: the staged kernel up to 64
    planes, at least two blocks an SM at the main path's depth, one wave of
    blocks on the production tile; the direct kernel deeper."""
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    r = fd.zy_route((16, 16, 1024, 1024), (3.0, 1.0, 1.0))
    assert r["kernel"] == "staged" and r["seg_rows"] == 32 and r["tile_x"] == 32
    assert r["blocks_per_sm"] >= 2 and r["grid"] == r["blocks_per_sm"] * sm
    assert fd.zy_route((2, 4, 9, 64), (3.0, 1.0, 1.0))["grid"] == 4  # 2 bits x 2 column tiles
    assert fd.zy_route((4, 70, 24, 136), (3.0, 1.0, 1.0))["kernel"] == "direct"


def _assert_ids_near_ties(k_ids, p_ids, lowpassed, cbt, bg, nm, thr=None, tol=1e-4):
    """Every decoded id that differs is a near-tie, recomputed in float64
    from the plain version's lowpassed traces (bits, M): the top-2
    similarity gap below ``tol``, or (with thresholds) the distance or the
    magnitude within ``tol`` of its threshold."""
    bad = np.flatnonzero(k_ids.cpu().numpy().ravel() != p_ids.cpu().numpy().ravel())
    if not bad.size:
        return
    t = lowpassed.cpu().numpy().astype(np.float64)[:, bad]
    s = np.clip((t - bg.cpu().numpy()[:, None]) / nm.cpu().numpy()[:, None], 0, 1)
    mag = np.sqrt((s * s).sum(0))
    sims = cbt.cpu().numpy().T.astype(np.float64) @ (s / np.maximum(mag, 1e-12))
    top2 = -np.sort(-sims, axis=0)[:2] if sims.shape[0] > 1 else np.vstack([sims, sims - 1])
    margins = [top2[0] - top2[1]]
    if thr is not None:
        (lo, hi), d_thr = thr["magnitude_threshold"], thr["distance_threshold"]
        d = np.sqrt(np.maximum(2 - 2 * top2[0], 0))
        margins += [np.abs(d - d_thr), np.abs(mag - lo), np.abs(mag - hi)]
    assert (np.min(margins, axis=0) < tol).all(), f"{bad.size} ids differ without a near-tie"


def _decode_operands(rng, cuda, bits, words):
    cb = _codebook(rng, words=words, bits=bits) if bits >= 4 else np.eye(words, bits, dtype=np.float32) + 0.5
    cbt = torch.as_tensor(dec.normalize_codebook(cb).T.copy(), device=cuda)
    bg = torch.as_tensor((rng.random(bits) * 0.1).astype(np.float32), device=cuda)
    nm = torch.as_tensor((rng.random(bits) + 0.5).astype(np.float32), device=cuda)
    return cbt, bg, nm


# (bits, words, n): both V routes, a bits_p pad (22 -> 24), one word, a
# ragged last group of V, n below one group
_K3_ODD = [(16, 90, 70_001), (22, 90, 4_099), (32, 90, 8_192), (16, 1, 1_003),
           (1, 3, 3), (5, 7, 1), (17, 40, 12_345)]


@pytest.mark.parametrize("bits,words,n", _K3_ODD)
def test_k3_odd_shapes_match_plain(cuda, bits, words, n):
    rng = np.random.default_rng(bits * 1000 + words)
    cbt, bg, nm = _decode_operands(rng, cuda, bits, words)
    traces = torch.as_tensor((rng.random((bits, n)) * 2).astype(np.float32), device=cuda)
    k = dec.decode_chunk_cuda(traces, cbt, bg, nm)
    p = dec.decode_chunk_plain(traces, cbt, bg, nm)
    torch.cuda.synchronize()
    for a, b in zip(k[1:], p[1:]):  # f32 FMA chains vs matmul order: a few ulp
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    _assert_ids_near_ties(k[0], p[0], traces, cbt, bg, nm)


def test_k3_scaling_is_ieee_division(cuda):
    """K3's scaled traces are clip((t - bg) / norm) bit for bit as torch
    divides on the card: through the kernel's branch-free division
    (operands in [2^-40, 2^40)) and through '/' for a thread holding any
    other operand (zeros, tiny or huge values, a norm out of range)."""
    rng = np.random.default_rng(6)
    bits, n = 16, 1 << 20
    nm = (2.0 ** rng.uniform(-39, 39, bits)).astype(np.float32)
    u = rng.random((bits, n)) * 2.0 ** -rng.integers(0, 30, (bits, n)).astype(np.float64)
    t = (u * nm[:, None]).astype(np.float32)
    t[:, :4096] *= np.float32(2.0**-60)  # these threads divide through '/'
    t[:, 4096:8192:3] = 0.0
    bg = np.zeros(bits, np.float32)
    bg[:4] = t[:4, 9000]  # exact zeros from t - bg, and shifted quotients
    cbt, _, _ = _decode_operands(rng, cuda, bits, 90)
    for norms in (nm, np.concatenate([nm[:15], [np.float32(3e15)]])):
        args = [torch.as_tensor(a, device=cuda) for a in (t, bg, norms)]
        k = dec.decode_chunk_cuda(args[0], cbt, args[1], args[2])
        p = dec.decode_chunk_plain(args[0], cbt, args[1], args[2])
        assert torch.equal(k[3], p[3])


def test_k3_strided_view_matches_packed(cuda):
    """A z-chunk view of a (bits, Z, Y, X) volume, as decode_volume passes
    it, and a view whose rows start off the 16-byte grid (the element-wise
    route) give what the same data packed gives, bit for bit."""
    rng = np.random.default_rng(5)
    cbt, bg, nm = _decode_operands(rng, cuda, 16, 90)
    vol = torch.as_tensor((rng.random((16, 11, 40, 72)) * 2).astype(np.float32), device=cuda)
    flat = torch.as_tensor((rng.random((16, 5001)) * 2).astype(np.float32), device=cuda)
    for view in (vol[:, 3:9].reshape(16, -1), vol[:, 8:].reshape(16, -1), flat[:, 1:5001]):
        assert not view.is_contiguous() and view.stride(1) == 1
        packed = view.contiguous()
        for want_scaled in (True, False):
            got = dec.decode_chunk_cuda(view, cbt, bg, nm, want_scaled=want_scaled)
            ref = dec.decode_chunk_cuda(packed, cbt, bg, nm, want_scaled=want_scaled)
            for a, b in zip(got, ref):
                assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_chunk_cuda(vol[:, 0, :, :2].reshape(16, -1)[:, ::2], cbt, bg, nm)


# (bits, words, (nz, ny, nx), sigma_x): nx 1 and 3 with pads wider than the
# row, 96 (the hermetic tile), 97 (a ragged segment, the element-wise
# stores), 1024 (two V = 4 segments, four V = 2 ones); sigma_x 1 (9 taps,
# the register window), 2.6 (21 taps, taps read from shared memory), 0
# (1 tap)
_K2_ODD = [
    (16, 90, (2, 3, 1), 1.0), (16, 90, (2, 3, 3), 2.6), (16, 90, (3, 5, 96), 1.0),
    (22, 90, (2, 7, 97), 1.0), (32, 90, (1, 4, 1024), 1.0), (16, 1, (2, 4, 1024), 1.0),
    (5, 7, (2, 6, 97), 0.0), (16, 90, (2, 5, 130), 2.6), (32, 24, (2, 3, 3), 1.0),
]


@pytest.mark.parametrize("bits,words,shape,sigma_x", _K2_ODD)
def test_k2_odd_shapes_match_plain(cuda, bits, words, shape, sigma_x):
    rng = np.random.default_rng(bits * 100 + shape[-1])
    cbt, bg, nm = _decode_operands(rng, cuda, bits, words)
    inter = torch.as_tensor((rng.random((bits, *shape)) * 2).astype(np.float32), device=cuda)
    thr = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)
    k = fd.x_lowpass_decode_cuda(inter, cbt, bg, nm, sigma_x=sigma_x, **thr)
    p = fd.x_lowpass_decode_plain(inter, cbt, bg, nm, sigma_x=sigma_x, **thr)
    torch.cuda.synchronize()
    for a, b in zip(k[1:], p[1:]):  # one f16 rounding step at most
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-10, atol=2**-14)
    lp = fd.gaussian_lowpass(inter, sigma=(0.0, 0.0, sigma_x)).reshape(bits, -1)
    _assert_ids_near_ties(k[0], p[0], lp, cbt, bg, nm, thr)


def test_k1_k2_match_plain(cuda):
    rng = np.random.default_rng(2)
    cb = _codebook(rng)
    vol = torch.as_tensor((rng.random((16, 6, 40, 150)) * 100).astype(np.float32), device=cuda)
    cbt = torch.as_tensor(dec.normalize_codebook(cb).T.copy(), device=cuda)
    bg = torch.as_tensor(rng.random(16).astype(np.float32), device=cuda)
    nm = torch.as_tensor(((rng.random(16) + 0.5) * 40).astype(np.float32), device=cuda)
    kw = dict(sigma=(3.0, 1.0, 1.0), magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)
    k = fd.fused_lowpass_decode(vol, cbt, bg, nm, **kw)
    p = fd.fused_lowpass_decode_plain(vol, cbt, bg, nm, **kw)
    torch.cuda.synchronize()
    assert (k[0] != p[0]).float().mean().item() <= 1e-3
    # f16 outputs: one f16 rounding step apart at most
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-10, atol=2**-14)


def test_wrappers_refuse_bad_input(cuda):
    vol = torch.zeros((16, 4, 8, 8), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        fd.zy_lowpass_cuda(vol, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        fd.zy_lowpass_cuda(torch.zeros((33, 4, 8, 8), device=cuda), (1.0, 1.0, 1.0))
    cbt = torch.zeros((16, 24), device=cuda)
    z = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError):
        fd.x_lowpass_decode_cuda(torch.zeros((16, 4, 8, 8)), cbt, z, z + 1, sigma_x=1.0,
                                 magnitude_threshold=(0.9, 10.0), distance_threshold=0.5)


def test_slab_streaming_on_card_matches_whole_volume(cuda):
    """y-slab streaming with halos launches K1+K2 per slab; it must give
    the whole-volume result exactly (same kernels, same arithmetic per
    voxel), dense and gathered."""
    rng = np.random.default_rng(3)
    cb = _codebook(rng)
    vol = (rng.random((16, 8, 100, 136)) * 2).astype(np.float32)
    for k in range(30):  # codeword spots through all z, so voxels decode
        y, x = rng.integers(0, 96), rng.integers(0, 131)
        vol[np.flatnonzero(cb[k % len(cb)]), :, y : y + 4, x : x + 5] += 90.0
    vol = torch.as_tensor(vol, device=cuda)
    bg = np.zeros(16, np.float32)
    nm = np.full(16, 40.0, np.float32)
    kw = dict(sigma=(3.0, 1.0, 1.0), magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)
    whole = fd.fused_decode_volume(vol, cb, bg, nm, **kw)
    slabs = fd.fused_decode_volume(vol, cb, bg, nm, y_slab=32, memory_budget_bytes=0,
                                   scaled_as="gather", **kw)
    for a, b in zip(whole[:3], slabs[:3]):
        np.testing.assert_array_equal(a, b)
    lin = np.flatnonzero(whole[0].ravel() >= 0)
    assert lin.size > 1000
    np.testing.assert_array_equal(slabs[3](lin), whole[3].reshape(16, -1)[:, lin].astype(np.float32))


def test_decode_volume_on_card_matches_cpu(cuda, launches):
    """K3 through decode_volume against the plain CPU path: ids equal except
    near-ties, f16 outputs one f16 step apart."""
    rng = np.random.default_rng(4)
    cb = _codebook(rng)
    vol = (rng.random((16, 11, 40, 72)) * 2).astype(np.float32)
    bg = (rng.random(16) * 0.1).astype(np.float32)
    nm = (rng.random(16) + 0.5).astype(np.float32)
    kw = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)
    gpu = dec.decode_volume(torch.as_tensor(vol, device=cuda), cb, bg, nm, **kw)
    cpu = dec.decode_volume(vol, cb, bg, nm, device="cpu", **kw)
    assert (gpu[0] != cpu[0]).mean() <= 1e-3
    for a, b in zip(gpu[1:], cpu[1:]):
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                   rtol=2**-10, atol=2**-14)
    # each z-chunk reaches K3 as a view of the volume, one launch a chunk,
    # also where a plane is not a multiple of V (the element-wise route)
    seen = []
    real = dec.decode_chunk_cuda

    def spy(traces, *args, **kw2):
        seen.append(traces.data_ptr())
        return real(traces, *args, **kw2)

    for v, z_chunk in ((torch.as_tensor(vol, device=cuda), 8),
                       (torch.as_tensor(vol[:, :, :9, :71].copy(), device=cuda), 3)):
        seen.clear()
        dec.decode_chunk_cuda = spy
        try:
            before = launches("decode_chunk_f32")
            got = dec.decode_volume(v, cb, bg, nm, z_chunk=z_chunk, return_scaled=False, **kw)
        finally:
            dec.decode_chunk_cuda = real
        chunks = range(0, 11, z_chunk)
        assert launches("decode_chunk_f32") - before == len(chunks)
        assert seen == [v[:, z0].data_ptr() for z0 in chunks]
        ref = dec.decode_volume(v.cpu().numpy(), cb, bg, nm, device="cpu", return_scaled=False, **kw)
        assert got[3] is None and (got[0] != ref[0]).mean() <= 1e-3
        for a, b in zip(got[1:3], ref[1:3]):
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=2**-10, atol=2**-14)


# ------------------------------------------------------------ DFT kernels
def _pair(rng, shape, cuda, complex_in=True):
    xr = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    xi = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda) if complex_in else None
    return xr, xi


def _assert_pair_close(got, want, scale):
    """The reference's own DFT tolerance (tests/test_pfft.py): 3e-5 x max|X|."""
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert (g - w).abs().max().item() <= 3e-5 * scale


_DFT_CASES = [
    ("dft_trailing", (6 * 40 + 1, 384)),  # ragged row block
    ("dft_trailing", (4 * 40 + 3, 2176)),  # n1 = 17 (the camera frame), rows not a multiple of 4
    ("dft_trailing", (64, 1920)),  # n1 = 15 (the camera crop)
    ("dft_trailing", (16, 3072)),  # n1 = 24, the longest line
    ("dft_middle", (3, 256, 384)),
    ("dft_middle", (2, 2176, 256)),  # n1 = 17 (the camera frame), eight 32-column tiles
    ("dft_middle", (3, 896, 384)),  # n1 = 7 (the production crop), x = 3 * 128
    ("dft_middle", (2, 3072, 128)),  # n1 = 24, the most values a pass-A thread holds
    ("dft_leading", (96, 8, 136)),
    ("dft_leading", (5, 16, 128)),
    ("dft_zx", (16, 24, 896)),  # the production crop's plane
    ("dft_zx", (96, 8, 512)),  # planes larger than shared memory: the largest z
    ("dft_zx", (18, 8, 3072)),  # ... and the largest x (n1 = 24)
    ("dft_zx", (32, 8, 1152)),  # the RLGC plane (n1 = 9)
    ("dft_zx", (27, 8, 896)),  # a ragged z: a partial 8-output chunk of the z pass
]


@pytest.mark.parametrize("name,shape", _DFT_CASES)
@pytest.mark.parametrize("complex_in", [False, True])
def test_dft_kernels_match_plain(cuda, name, shape, complex_in):
    from merfish3d_tpu_torch.ops import pfft

    rng = np.random.default_rng(5)
    kernel, plain = getattr(pfft, f"{name}_cuda"), getattr(pfft, f"{name}_plain")
    xr, xi = _pair(rng, shape, cuda, complex_in)
    fk, fp = kernel(xr, xi), plain(xr, xi)
    torch.cuda.synchronize()
    _assert_pair_close(fk, fp, max(fp[0].abs().max().item(), fp[1].abs().max().item()))
    for real_output in (False, True):  # real_output: the inverse returns no imaginary plane
        ik = kernel(*fp, inverse=True, real_output=real_output)
        ip = plain(*fp, inverse=True, real_output=real_output)
        torch.cuda.synchronize()
        assert (ik[1] is None) == real_output
        _assert_pair_close(ik, ip, xr.abs().max().item())
        assert (ik[0] - xr).abs().max().item() <= 3e-5 * xr.abs().max().item()


def test_dft_wrappers_refuse_bad_input(cuda):
    from merfish3d_tpu_torch.ops import pfft

    with pytest.raises(ValueError):
        pfft.dft_trailing_cuda(torch.zeros((8, 200), device=cuda))
    with pytest.raises(ValueError):
        pfft.dft_middle_cuda(torch.zeros((2, 256, 100), device=cuda))
    with pytest.raises(ValueError):
        pfft.dft_zx_cuda(torch.zeros((2, 8, 256)))  # CPU tensor
    with pytest.raises(TypeError):
        pfft.dft_leading_cuda(torch.zeros((8, 8, 128), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        pfft.dft_leading_cuda(torch.zeros((97, 8, 128), device=cuda))


@pytest.mark.parametrize("n", range(2, 97))
def test_k8_lengths_match_plain(cuda, launches, n):
    """K8 at every length it takes, through the kernel its route names (the
    radix route or K10's z pass): forward on complex and real input,
    inverse to complex and real output, at a small ragged plane (600
    columns), within 3e-5 x max|X|."""
    from merfish3d_tpu_torch.ops import pfft

    rng = np.random.default_rng(n)
    shape = (n, 6, 100)
    route = pfft.leading_route(n)
    before = launches(f"dft_leading.{route}")
    for complex_in in (False, True):
        xr, xi = _pair(rng, shape, cuda, complex_in)
        fk, fp = pfft.dft_leading_cuda(xr, xi), pfft.dft_leading_plain(xr, xi)
        torch.cuda.synchronize()
        _assert_pair_close(fk, fp, max(fp[0].abs().max().item(), fp[1].abs().max().item()))
        for real_output in (False, True):
            ik = pfft.dft_leading_cuda(*fp, inverse=True, real_output=real_output)
            ip = pfft.dft_leading_plain(*fp, inverse=True, real_output=real_output)
            torch.cuda.synchronize()
            assert (ik[1] is None) == real_output
            _assert_pair_close(ik, ip, max(ip[0].abs().max().item(), xr.abs().max().item()))
    assert launches(f"dft_leading.{route}") == before + 6


# ------------------------------------------------------------ RLGC kernels
@pytest.mark.parametrize(
    "shape",
    [(3, 256, 384), (4, 1152, 256), (2, 2176, 128), (2, 2304, 128), (2, 3072, 256)],
)
def test_k9_matches_plain(cuda, shape):
    """K9 against its plain version within the DFT tolerance, 3e-5 x max|y|,
    at n1 = 2, 9 (the RLGC shape), 17, 18 (the gate's largest y length) and
    24 (the kernel's largest, past the gate), complex and real input."""
    from merfish3d_tpu_torch.ops import pfft

    assert pfft.mid_conv_supported(shape) == (shape[1] <= 2304)
    rng = np.random.default_rng(6)
    hr, hi = _pair(rng, shape, cuda)
    for complex_in in (True, False):
        xr, xi = _pair(rng, shape, cuda, complex_in)
        k, p = pfft.dft_mid_conv_cuda(xr, xi, hr, hi), pfft.dft_mid_conv_plain(xr, xi, hr, hi)
        torch.cuda.synchronize()
        _assert_pair_close(k, p, max(p[0].abs().max().item(), p[1].abs().max().item()))


_EW_CASES = [
    ((27, 128, 128), ((7, 8), (16, 16), (16, 16))),  # the hermetic decon volume
    ((4, 8, 4096), ((1, 1), (2, 1), (3, 5))),  # rows wider than a block: two quads a thread
    ((6, 16, 384), ((0, 0), (0, 0), (0, 0))),  # no padding at all
]


@pytest.mark.parametrize("shape,pad_width", _EW_CASES)
def test_k4_k5_match_plain(cuda, shape, pad_width):
    """K4: ratios equal (the same division), KLDs within 1e-5 relative (an
    FP64 fold against the plain f32 chain). K5 under both restore flags:
    selects equal, count and maxima exact."""
    from merfish3d_tpu_torch.ops import rlgc_kernels as rk

    rng = np.random.default_rng(7)

    def vol(a):
        return torch.as_tensor(a.astype(np.float32), device=cuda)

    hu = vol(rng.normal(50.0, 30.0, shape))
    s1, s2 = vol(rng.poisson(20.0, shape)), vol(rng.poisson(20.0, shape))
    k, p = rk.ratio_kld_cuda(hu, s1, s2, pad_width), rk.ratio_kld_plain(hu, s1, s2, pad_width)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for a, b in zip(k[2], p[2]):
        assert abs(a.item() - b.item()) <= 1e-5 * abs(b.item())
    cons, ht = vol(rng.normal(0.0, 1.0, shape)), vol(rng.uniform(0.2, 1.8, shape))
    rec, prev = vol(rng.uniform(0.5, 2.0, shape)), vol(rng.uniform(0.5, 2.0, shape))
    for restore in (False, True):
        flag = torch.tensor(restore, device=cuda)
        k = rk.update_select_cuda(cons, rec, prev, ht, flag, pad_width)
        p = rk.update_select_plain(cons, rec, prev, ht, flag, pad_width)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert [t.item() for t in k[2:]] == [t.item() for t in p[2:]]


def test_rlgc_wrappers_refuse_bad_input(cuda):
    from merfish3d_tpu_torch.ops import pfft
    from merfish3d_tpu_torch.ops import rlgc_kernels as rk

    pw = ((0, 0), (0, 0), (0, 0))
    x = torch.zeros((2, 8, 128), device=cuda)
    with pytest.raises(ValueError):
        rk.ratio_kld_cuda(torch.zeros((2, 8, 100), device=cuda), x, x, pw)  # x % 128
    with pytest.raises(ValueError):
        rk.ratio_kld_cuda(torch.zeros((2, 8, 128)), x, x, pw)  # CPU tensor
    with pytest.raises(TypeError):
        rk.update_select_cuda(x.double(), x, x, x, False, pw)
    with pytest.raises(ValueError):
        pfft.dft_mid_conv_cuda(x, x, x, None)  # the OTF must be complex
    with pytest.raises(ValueError):
        pfft.dft_mid_conv_cuda(*(torch.zeros((2, 100, 128), device=cuda) for _ in range(4)))
    with pytest.raises(ValueError):
        pfft.dft_mid_conv_cuda(*(torch.zeros((2, 256, 96), device=cuda) for _ in range(4)))


def test_rlgc_solve_on_card_matches_cpu(cuda):
    """A paired solve on the card (K4, K5, K8 on z, torch.fft elsewhere)
    against the same solve on CPU, with the splits drawn on CPU for both:
    the same iteration counts; recons within 1e-4 x max except at the
    voxels whose consensus gate flips on rounding (a discontinuous select,
    which flips between any two FP32 implementations: at most 1 % of the
    voxels), and within 1e-2 in L2."""
    from merfish3d_tpu_torch.ops import rlgc

    rng = np.random.default_rng(8)
    obs = rng.poisson(20.0 + 200.0 * (rng.random((3, 12, 96, 96)) > 0.999), (3, 12, 96, 96))
    psf = np.ones((5, 15, 15), np.float32) / 1125.0  # pads to (16, 128, 128): K4, K5 and K8 take it

    def split(observed, seed, it):
        return rlgc.binomial_split(observed.cpu(), seed, it).to(observed.device)

    kw = dict(seed=3, max_iters=8, split_fn=split, return_iters=True)
    gpu, it_g = rlgc.rlgc_batch(torch.as_tensor(obs.astype(np.float32), device=cuda), psf, **kw)
    cpu, it_c = rlgc.rlgc_batch(obs.astype(np.float32), psf, device="cpu", **kw)
    assert it_g == it_c
    assert np.mean(np.abs(gpu - cpu) > 1e-4 * np.abs(cpu).max()) <= 0.01
    assert np.linalg.norm(gpu - cpu) <= 1e-2 * np.linalg.norm(cpu)


# ------------------------------------------------------------ U-FISH K11
def _within_one_bf16_step(got, want):
    """One bf16 rounding step at the larger magnitude, plus 2**-20 x max
    for outputs near zero: the same bf16 operands, f32 sums in another
    order."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0**-126)
    limit = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2.0**-20 * want.abs().max()
    return bool(((got - want).abs() <= limit).all())


_K11_CASES = [
    ((2, 64, 160, 32), (3, 3, 32, 32), "relu"),  # ragged x tile
    ((1, 45, 40, 1), (3, 3, 1, 8), "relu"),  # the first conv: Cin = 1, ragged y tile
    ((2, 32, 64, 64), (2, 2, 64, 32), "none"),  # the resize decoder's 2x2 conv
    ((1, 33, 130, 24), (1, 1, 24, 1), "sigmoid"),  # the head: Co = 1
    ((1, 16, 16, 128), (3, 3, 128, 256), "none"),  # Cin and Co past one chunk each
    ((3, 20, 36, 5), (1, 3, 5, 19), "relu"),  # odd widths, a 1x3 kernel
    ((1, 24, 40, 128), (1, 1, 128, 256), "none"),  # c32's 1x1 up-conv: two N halves
    ((1, 24, 40, 128), (3, 3, 128, 128), "relu"),  # c32's bottleneck
    ((2, 32, 100, 64), (3, 3, 64, 32), "relu"),  # c32's last decoder conv, ragged width
    ((2, 40, 72, 8), (3, 3, 8, 8), "relu"),  # the c8 net: Cin = 8
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,kshape,act", _K11_CASES)
def test_k11_matches_plain(cuda, launches, shape, kshape, act, dtype):
    """K11 against its plain version (F.conv2d on f32 copies): bf16 within
    one bf16 step, f32 within 2e-5 x max (sums in another order). bf16
    operands, narrow layers included, take the tensor-core kernel; f32
    operands the FP32-core kernel."""
    from merfish3d_tpu_torch.ops import conv2d as c2

    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda).to(dtype)
    w = torch.as_tensor((rng.standard_normal(kshape) * 0.2).astype(np.float32), device=cuda).to(dtype)
    b = torch.as_tensor(rng.standard_normal(kshape[-1]).astype(np.float32), device=cuda)
    k = c2.conv2d_same(x, w, b, act=act)
    p = c2.conv2d_same_plain(x, w, b, act=act)
    torch.cuda.synchronize()
    mma = dtype == torch.bfloat16
    assert (launches("conv2d_same_mma_bf16"), launches("conv2d_same_f32")) == (mma, not mma)
    assert k.dtype == dtype and k.shape == p.shape
    if dtype == torch.bfloat16:
        assert _within_one_bf16_step(k, p)
        k32 = c2.conv2d_same_cuda(x, w, b, act=act, out_dtype=torch.float32)
        torch.testing.assert_close(k32, c2.conv2d_same_plain(x, w, b, act=act, out_dtype=torch.float32),
                                   rtol=0, atol=2e-5 * p.float().abs().max().item())
    else:
        assert (k - p).abs().max().item() <= 2e-5 * p.abs().max().item()


def test_k11_wrapper_refuses_bad_input(cuda):
    from merfish3d_tpu_torch.ops import conv2d as c2

    x = torch.zeros((1, 8, 8, 4), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 4, 4), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        c2.conv2d_same_cuda(x.cpu(), w, b)  # CPU tensor
    with pytest.raises(TypeError):
        c2.conv2d_same_cuda(x, w.float(), b)  # mixed operand types
    with pytest.raises(ValueError):
        c2.conv2d_same_cuda(x, torch.zeros((5, 5, 4, 4), device=cuda, dtype=torch.bfloat16), b)
    with pytest.raises(ValueError):
        c2.conv2d_same_cuda(x, w[:, :, :3], b)  # Cin mismatch
    with pytest.raises(TypeError):
        c2.conv2d_same_cuda(x, w, b, out_dtype=torch.float16)


def test_predictor_batch_on_card_matches_plain(cuda, launches, monkeypatch):
    """One 8-plane batch of 256x256 planes through the c8 checkpoint's
    U-Net on the card, through K11 and through the plain convolutions: one
    layer's one-step bf16 differences travel through the later layers, so
    the maps agree within 2**-7 with at most 1 % of the values differing;
    and with the same predictor on the CPU."""
    from pathlib import Path

    from merfish3d_tpu_torch.models import ufish
    from merfish3d_tpu_torch.ops import conv2d as c2

    variables = ufish.load_checkpoint(Path(__file__).parent / "data" / "ufish_synthetic_c8.pkl")
    planes = np.random.default_rng(10).poisson(40.0, (8, 256, 256)).astype(np.float32)
    planes[:, 100:104, 50:54] += 900.0
    pred = ufish.UFishPredictor(params=variables, device=cuda)
    before = (launches("conv2d_same_mma_bf16"), launches("conv2d_same_f32"))
    got = pred.predict_planes(torch.as_tensor(planes, device=cuda))
    # every conv of the c8 U-Net once, the first (Cin = 1) and the head
    # (Co = 1) included, through the tensor-core kernel
    assert (launches("conv2d_same_mma_bf16") - before[0], launches("conv2d_same_f32") - before[1]) == (13, 0)
    monkeypatch.setattr(ufish, "conv2d_same", c2.conv2d_same_plain)
    want = pred.predict_planes(torch.as_tensor(planes, device=cuda))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2.0**-7
    assert (got != want).float().mean().item() <= 0.01
    cpu = ufish.UFishPredictor(params=variables, device="cpu").predict(planes)
    np.testing.assert_allclose(got.cpu().numpy(), cpu, rtol=0, atol=2.0**-7)


@pytest.mark.parametrize("kind", ["translate", "diagonal", "general"])
def test_warp_classes_match_cpu(cuda, kind):
    """The affine warps (plain torch) give the CPU port's result on the
    card, within 1e-5 · max, past x = 512 and across every face."""
    from merfish3d_tpu_torch.ops import warp

    rng = np.random.default_rng(7)
    image = torch.as_tensor((rng.random((6, 40, 560)) * 1000).astype(np.float32))
    t = np.eye(4)
    t[:3, 3] = (0.41, -0.73, 1.9)
    if kind != "translate":
        t[1, 1], t[2, 2] = 0.9982, 0.998
    if kind == "general":
        t[1, 2], t[2, 1] = 0.0021, -0.0017
    spacing = (0.315, 0.098, 0.098)
    assert warp._warp_class(warp.transform_to_pixel(t, spacing)[0]) == kind
    kw = dict(transform_zyx_um=t, spacing_zyx_um=spacing, reference_shape=tuple(image.shape))
    got = warp.warp_affine(image.to(cuda), **kw)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), warp.warp_affine(image, **kw), rtol=0, atol=1e-5 * 1000)


def _labels_on_card(cuda, decoded):
    from merfish3d_tpu_torch.ops import components as comp

    lin, roots = comp.label_components(torch.as_tensor(decoded, device=cuda))
    torch.cuda.synchronize()
    return lin.cpu().numpy(), roots.cpu().numpy()


@pytest.mark.parametrize("name", [
    "empty", "one_voxel", "faces_and_corners", "diagonals", "stripes", "block_and_snake",
    "random_sparse", "random_dense", "tile",
])
def test_labeller_matches_native(cuda, launches, name):
    """``label_components_i16``'s components are the native labeller's, in
    its order: every foreground voxel's root is the smallest linear index
    of the native component it lies in. ``block_and_snake`` holds a
    component of 8000 voxels, far past a thread block; ``tile`` is a
    production tile's size, (16, 1024, 1024), ~3 % foreground."""
    from torch_extract_cases import CASES, native_roots, spot_volume

    decoded = spot_volume() if name == "tile" else CASES[name]
    lin, roots = _labels_on_card(cuda, decoded)
    want_lin, want_roots = native_roots(decoded)
    np.testing.assert_array_equal(lin, want_lin)
    np.testing.assert_array_equal(roots, want_roots)
    assert launches("label_components_i16") == 1
    if name == "tile":
        again = _labels_on_card(cuda, decoded)
        np.testing.assert_array_equal(again[1], roots)


def test_labeller_matches_plain(cuda):
    from merfish3d_tpu_torch.ops import components as comp
    from torch_extract_cases import random_volume

    decoded = torch.as_tensor(random_volume((6, 40, 70), fg=0.4, words=2, seed=9))
    got = comp.label_volume_cuda(decoded.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), comp.label_volume_plain(decoded))


def _stats_inputs(shape, *, bits, half, seed=0):
    """Float16 distance and magnitude, and (bits, Z, Y, X) intensities of
    wide dynamic range, so any change of summation order shows."""
    rng = np.random.default_rng(seed)
    dist = rng.random(shape, dtype=np.float32).astype(np.float16)
    mag = (rng.random(shape, dtype=np.float32) * 4).astype(np.float16)
    vals = rng.random((bits, *shape), dtype=np.float32) - 0.5
    vals *= np.exp2(rng.integers(-12, 12, (bits, *shape), dtype=np.int8), dtype=np.float32)
    return dist, mag, vals.astype(np.float16) if half else vals


def _host_stats(decoded, dist, mag, vals, **kw):
    """``component_stats_host`` through the host path: native labels,
    numpy sums."""
    from merfish3d_tpu_torch import native
    from merfish3d_tpu_torch.ops.cc import component_stats_host

    dec32 = decoded.astype(np.int32)
    return component_stats_host(dec32, native.label_components_sparse(dec32), dist.astype(np.float32),
                                mag.astype(np.float32), vals, **kw)


def _card_stats(cuda, decoded, dist, mag, vals, **kw):
    """``component_stats_host`` through the card's labeller and sums."""
    from merfish3d_tpu_torch.ops import components as comp
    from merfish3d_tpu_torch.ops.cc import component_stats_host

    dec_t = torch.as_tensor(decoded, device=cuda)
    return component_stats_host(
        dec_t, comp.label_components(dec_t), torch.as_tensor(dist, device=cuda),
        torch.as_tensor(mag, device=cuda), torch.as_tensor(vals, device=cuda), **kw,
    )


@pytest.mark.parametrize("window", [None, (4.0, 40.0)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("half", [False, True])
def test_component_sums_match_host_bit_for_bit(cuda, launches, half, weighted, window):
    from torch_extract_cases import random_volume

    decoded = random_volume((6, 30, 40), fg=0.4, words=3, seed=3)
    inputs = _stats_inputs(decoded.shape, bits=6, half=half)
    kw = dict(collect_weighted_centroids=weighted, size_window=window)
    want = _host_stats(decoded, *inputs, **kw)
    got = _card_stats(cuda, decoded, *inputs, **kw)
    assert list(got) == list(want) and len(want["area"]) > 50
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert launches("component_sums_f64") == 1 and launches("label_components_i16") == 1


@pytest.mark.parametrize("weighted", [False, True])
def test_component_sums_at_tile_size(cuda, launches, weighted):
    """A production tile's size, 16 bits of float16 (the final decode's
    scaled values), the decoder's window: bit-equal to the host, twice;
    ``extract.components`` counts every component before the window."""
    from merfish3d_tpu_torch.utils import profiling
    from torch_extract_cases import native_roots, spot_volume

    decoded = spot_volume(seed=4)
    inputs = _stats_inputs(decoded.shape, bits=16, half=True, seed=5)
    kw = dict(collect_weighted_centroids=weighted, size_window=(16.0, 500.0))
    want = _host_stats(decoded, *inputs, **kw)
    got = _card_stats(cuda, decoded, *inputs, **kw)
    again = _card_stats(cuda, decoded, *inputs, **kw)
    assert len(want["area"]) > 1000
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)
    n_components = np.unique(native_roots(decoded)[1]).size
    counters = profiling.snapshot()["counters"]
    assert counters["extract.components"]["total"] == 2 * n_components
    assert launches("component_sums_f64") == 2


def test_decoder_tables_on_card_match_host_route(cuda, launches):
    """A small tile decoded on the card: the tables through the device
    extraction equal, row for row and value for value, those through the
    host extraction the decoder takes on the CPU, with the chromatic
    centroids."""
    import copy

    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import generate_raw_experiment
    from merfish3d_tpu_torch.cli.simulation.convert_to_datastore import convert_data
    from merfish3d_tpu_torch.pipeline.decoder import PixelDecoder
    from merfish3d_tpu_torch.pipeline.registration import DataRegistration

    store = convert_data(generate_raw_experiment(shape=(12, 96, 96), seed=11, distribution="cells"), device=cuda)
    DataRegistration(store, device=cuda, decon_fiducial=False, decon_readout=False,
                     ufish_model="dog").register_all_tiles()
    tables = []
    for on_device in (False, True):
        s = copy.deepcopy(store)
        decoder = PixelDecoder(s, device=cuda, minimum_pixels=4, magnitude_threshold=(0.9, 10.0),
                               estimate_chromatic_affines=True)
        decoder._extract_on_device = on_device
        decoder.optimize_normalization_by_decoding(n_random_tiles=1, n_iterations=2)
        filtered = decoder.decode_all_tiles()
        tables.append([*(s.iteration_checkpoints[i][0] for i in sorted(s.iteration_checkpoints)),
                       s.decoded_tables[0], filtered])
    assert launches("label_components_i16") == launches("component_sums_f64") == 3
    for got, want in zip(*tables[::-1]):
        assert list(got) == list(want) and len(want["area"]) > 20
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype, k
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), k
