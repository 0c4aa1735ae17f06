"""A CPU model of the nearest-codeword core shared by K2 and K3
(csrc/decode_core.cuh) and of K2's staged x pass (csrc/fused_decode.cu).

The card's kernels cannot run here, so their layouts are held through a
torch emulation of their loops, driven by what the wrappers upload: the
packed codebook (``ops.decode.pack_codebook``, bits padded by zeros to a
multiple of 4), K2's taps and symmetric index map (``_x_taps``, the
tensors ``x_lowpass_decode_cuda`` passes) and, for K3, the view's own
row stride. The core model takes V pixels a thread (``voxels_per_thread``)
with zeros past N, reads each row at ``b * bit_stride + p`` of the view's
storage, and projects the unit traces onto the padded codewords in float4
groups with a strict first maximum. K2's model stages each (z, y) row
segment of 128 * V outputs with its halo as the kernel does: the row's own
sample inside the row, xmap's reflection outside, NaN wherever nothing is
staged, so an output that read an unstaged place would come out NaN; each
thread then sums its V + taps - 1 window in ascending tap order. The block
width and the window's tap count are read from the kernel source.

Held to the plain versions (``decode_chunk_plain``,
``x_lowpass_decode_plain``'s lowpass and decode) within FLOAT_RTOL =
1e-4 x max (float32 sums in another order), decoded ids equal except at
near-ties under 1e-4; and, once, to the reference's Pallas decode kernel
in interpret mode on the same seeded input.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfish3d_tpu.ops import decode as jdec
from merfish3d_tpu_torch.ops import decode as dec
from merfish3d_tpu_torch.ops import fused_decode as fd
from merfish3d_tpu_torch.ops.filters import gaussian_lowpass
from test_torch_cuda import _assert_ids_near_ties, _codebook

FLOAT_RTOL = 1e-4
THR = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)
CSRC = Path(dec.__file__).parent.parent / "csrc"


def _source_int(name: str, source: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


THREADS_K3 = _source_int("kThreads", "decode.cu")
THREADS_K2 = _source_int("kThreadsX", "fused_decode.cu")
WINDOW_TAPS = _source_int("kWindowTaps", "fused_decode.cu")


def _storage_rows(traces: torch.Tensor) -> torch.Tensor:
    """(bits, N) values read as the kernel reads a view: element (b, p) at
    storage offset + b * stride(0) + p."""
    bits, n = traces.shape
    flat = torch.tensor([], dtype=torch.float32).set_(traces.untyped_storage())
    idx = traces.storage_offset() + torch.arange(bits)[:, None] * traces.stride(0) + torch.arange(n)
    return flat[idx]


def core_model(traces, packed, bg, nm):
    """The core on (bits, N) traces: returns (best, dist, mag, scaled)."""
    bits, n = traces.shape
    words, bits_p = packed.shape
    v = dec.voxels_per_thread(bits)
    assert bits_p % 4 == 0 and bits_p - bits < 4
    groups = -(-n // v)
    raw = torch.zeros((bits, groups * v))
    raw[:, :n] = traces  # zeros past N, as the tail's copies give
    s = torch.zeros((bits_p, groups, v))
    s[:bits] = ((raw - bg[:, None]) / nm[:, None]).clamp(0.0, 1.0).reshape(bits, groups, v)
    msq = torch.zeros((groups, v))
    for b in range(bits):  # ascending bits, from +0
        msq = msq + s[b] * s[b]
    mag = torch.sqrt(msq)
    u = s / torch.clamp(mag, min=1e-12)
    best = torch.full((groups, v), -torch.inf)
    arg = torch.zeros((groups, v), dtype=torch.int32)
    cb4 = packed.reshape(words, bits_p // 4, 4)
    for w in range(words):
        sim = torch.zeros((groups, v))
        for g in range(bits_p // 4):  # one float4 of the word feeds all V pixels
            for k in range(4):
                sim = sim + cb4[w, g, k] * u[4 * g + k]
        better = sim > best  # strict: the first maximum stays
        best = torch.where(better, sim, best)
        arg = torch.where(better, torch.tensor(w, dtype=torch.int32), arg)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    flat = lambda t: t.reshape(-1)[:n]  # noqa: E731
    return flat(arg), flat(dist), flat(mag), s[:bits].reshape(bits, -1)[:, :n]


def x_pass_model(inter, sigma_x):
    """K2's staged x pass: (bits, Z, Y, X) lowpassed along x."""
    bits, nz, ny, nx = inter.shape
    kx, xmap = fd._x_taps(nx, float(sigma_x), torch.device("cpu"))
    taps, r = kx.numel(), (kx.numel() - 1) // 2
    v = dec.voxels_per_thread(bits)
    seg = THREADS_K2 * v
    tw = WINDOW_TAPS if taps <= WINDOW_TAPS else 0
    slen = seg + ((max(taps, tw) + v + 3) & ~3)  # stage_len
    rows = inter.reshape(bits, nz * ny, nx)
    out = torch.full((bits, nz * ny, nx), torch.nan)
    for x0 in range(0, nx, seg):
        nstage = min(seg + taps - 1, nx + taps - 1 - x0)
        assert -(-nstage // 4) * 4 <= slen  # the last 16-byte copy fits
        src = torch.arange(nstage) + x0 - r
        outside = (src < 0) | (src >= nx)
        src[outside] = xmap[x0 + torch.nonzero(outside).reshape(-1)].long()
        buf = torch.full((bits, nz * ny, slen), torch.nan)
        buf[..., :nstage] = rows[..., src]
        xb = torch.arange(THREADS_K2) * v
        active = xb + x0 < nx
        xb = xb[active]
        if tw:  # the register window: V-wide loads past the last tap stay in the buffer
            assert int(xb.max()) + -(-(v + tw - 1) // v) * v <= slen
        acc = torch.zeros((bits, nz * ny, xb.numel(), v))
        for k in range(taps):  # ascending taps, from +0
            idx = xb[:, None] + torch.arange(v)[None, :] + k
            acc = acc + kx[k] * buf[..., idx]
        vals = acc.reshape(bits, nz * ny, -1)
        xs = (x0 + xb[:, None] + torch.arange(v)[None, :]).reshape(-1)
        keep = xs < nx
        out[..., xs[keep]] = vals[..., keep]
    assert not torch.isnan(out).any(), "an output read a place nothing was staged into"
    return out.reshape(bits, nz, ny, nx)


def _operands(seed, bits, words, shape):
    rng = np.random.default_rng(seed)
    cb = _codebook(rng, words=words, bits=bits)
    cbt = torch.as_tensor(dec.normalize_codebook(cb).T.copy())
    bg = torch.as_tensor((rng.random(bits) * 0.1).astype(np.float32))
    nm = torch.as_tensor((rng.random(bits) + 0.5).astype(np.float32))
    data = torch.as_tensor((rng.random((bits, *shape)) * 2).astype(np.float32))
    return cb, cbt, bg, nm, data


def _assert_close(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= FLOAT_RTOL * want.abs().max().item(), f"{what}: max |err| {err:.3e}"


@pytest.mark.parametrize("bits", [4, 5, 16, 22, 32])
def test_pack_codebook_layout(bits):
    """(words, bits_p): the normalized codewords, bits_p the next multiple
    of 4, every pad place exactly zero."""
    cbt = torch.as_tensor(np.random.default_rng(bits).random((bits, 7)).astype(np.float32))
    packed = dec.pack_codebook(cbt)
    assert packed.shape == (7, -(-bits // 4) * 4) and packed.is_contiguous()
    assert torch.equal(packed[:, :bits], cbt.T)
    assert not packed[:, bits:].any()
    assert dec.voxels_per_thread(bits) == (4 if bits <= 16 else 2)


# (bits, words, n, view): both V routes, a bits_p pad, one word, ragged
# tails of a V group, a z-chunk view of a (bits, Z, Y, X) volume
_K3_CASES = [
    (16, 90, 4096, False), (16, 90, 4097, False), (22, 90, 3001, False),
    (32, 90, 2050, False), (16, 1, 333, False), (5, 7, 3, False),
    (16, 90, 6 * 24, True), (22, 40, 5 * 30, True),
]


@pytest.mark.parametrize("bits,words,n,view", _K3_CASES)
def test_core_model_matches_plain(bits, words, n, view):
    cb, cbt, bg, nm, data = _operands(bits + n, bits, words, (n,))
    if view:  # the chunk decode_volume hands over: planes 2..7 of 11
        vol = torch.as_tensor(np.random.default_rng(n).random((bits, 11, n // 6)).astype(np.float32) * 2)
        traces = vol[:, 2:8].reshape(bits, -1)
        assert not traces.is_contiguous() and traces.stride(0) == 11 * (n // 6)
    else:
        traces = data
    dec.check_decode_inputs(traces, cbt, bg, nm)
    got = core_model(_storage_rows(traces), dec.pack_codebook(cbt), bg, nm)
    want = dec.decode_chunk_plain(traces, cbt, bg, nm)
    for name, a, b in zip(("dist", "mag", "scaled"), got[1:], want[1:]):
        _assert_close(a, b, name)
    _assert_ids_near_ties(got[0], want[0], traces, cbt, bg, nm)
    shape = (bits, n)
    ids = [dec.assign_pixels(*r, shape, **THR)[0] for r in (got, want)]
    _assert_ids_near_ties(*ids, traces, cbt, bg, nm, THR)


# (bits, words, (nz, ny, nx), sigma_x): nx 1 and 3 with pads wider than the
# row (9 taps: r = 4; 21 taps: r = 10), the hermetic 96, a ragged 97, two
# V = 4 segments (1024, four at V = 2), the register window (9 taps), taps
# read from shared memory (21), one tap
_K2_CASES = [
    (16, 90, (1, 2, 1), 1.0), (16, 90, (1, 2, 3), 2.6), (22, 90, (1, 2, 3), 1.0),
    (16, 90, (2, 2, 96), 1.0), (32, 90, (1, 2, 97), 1.0), (16, 1, (1, 2, 97), 2.6),
    (16, 90, (1, 2, 1024), 1.0), (32, 40, (1, 1, 1024), 1.0), (22, 1, (1, 2, 96), 0.0),
    (16, 90, (1, 2, 1), 2.6),
]


@pytest.mark.parametrize("bits,words,shape,sigma_x", _K2_CASES)
def test_k2_model_matches_plain(bits, words, shape, sigma_x):
    cb, cbt, bg, nm, inter = _operands(bits * 7 + shape[-1], bits, words, shape)
    lp = gaussian_lowpass(inter, sigma=(0.0, 0.0, sigma_x))
    got_lp = x_pass_model(inter, sigma_x)
    _assert_close(got_lp, lp, "x pass")
    traces = lp.reshape(bits, -1)
    got = core_model(got_lp.reshape(bits, -1), dec.pack_codebook(cbt), bg, nm)
    want = dec.decode_chunk_plain(traces, cbt, bg, nm)
    for name, a, b in zip(("dist", "mag", "scaled"), got[1:], want[1:]):
        _assert_close(a, b, name)
    ids = dec.assign_pixels(*got, lp.shape, **THR)[0]
    plain = fd.x_lowpass_decode_plain(inter, cbt, bg, nm, sigma_x=sigma_x, **THR)
    _assert_ids_near_ties(ids, plain[0], traces, cbt, bg, nm, THR)


def test_core_model_matches_pallas_interpret():
    """The core model against the reference's Pallas decode kernel
    (interpret mode), on one seeded input with a ragged tail."""
    from jax.experimental.pallas import tpu as pltpu

    cb, cbt, bg, nm, traces = _operands(7, 16, 90, (3001,))
    args = (jnp.asarray(traces.numpy()), jnp.asarray(cbt.numpy()), jnp.asarray(bg.numpy()),
            jnp.asarray(nm.numpy()))
    with pltpu.force_tpu_interpret_mode():
        ref = jdec._decode_chunk_pallas(*args, tile_n=512)
    got = core_model(_storage_rows(traces), dec.pack_codebook(cbt), bg, nm)
    for name, a, b in zip(("dist", "mag", "scaled"), got[1:], ref[1:]):
        _assert_close(a, torch.as_tensor(np.asarray(b)), name)
    _assert_ids_near_ties(got[0], torch.as_tensor(np.asarray(ref[0])), traces, cbt, bg, nm)
