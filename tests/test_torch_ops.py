"""merfish3d_tpu_torch ops against the JAX package, on CPU.

Inputs come from numpy seeds and go through both the JAX function and its
PyTorch counterpart. Where the JAX function reaches a Pallas kernel, it
runs in interpret mode (as tests/test_decode_ops.py does); the port runs
its kernels' plain torch versions (CPU tensors). Each tolerance is stated
with its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merfish3d_tpu.ops import cc as jcc
from merfish3d_tpu.ops import decode as jdec
from merfish3d_tpu.ops import filters as jfilt
from merfish3d_tpu.ops import fused_decode as jfused
from merfish3d_tpu_torch.ops import cc as tcc
from merfish3d_tpu_torch.ops import decode as tdec
from merfish3d_tpu_torch.ops import filters as tfilt
from merfish3d_tpu_torch.ops import fused_decode as tfused
from torch_port_common import mhd4_codebook

KW = dict(magnitude_threshold=(0.9, 10.0), distance_threshold=0.5176)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _near_tie_only(diff_idx, traces2d, cb, bg, nm, tol=1e-4):
    """Every differing id is a near-tie: top-2 similarity gap or the
    distance/magnitude threshold margin below ``tol`` (f64 recompute)."""
    s = np.clip((traces2d.astype(np.float64) - bg[:, None]) / nm[:, None], 0, 1)
    mag = np.sqrt((s * s).sum(0))
    unit = s / np.maximum(mag, 1e-12)
    sims = tdec.normalize_codebook(cb).astype(np.float64) @ unit
    for i in diff_idx:
        top2 = np.sort(sims[:, i])[::-1][:2]
        dist = np.sqrt(max(2 - 2 * top2[0], 0))
        margins = (top2[0] - top2[1], abs(dist - KW["distance_threshold"]),
                   abs(mag[i] - 0.9), abs(mag[i] - 10.0))
        assert min(margins) < tol, f"voxel {i} differs without a near-tie"


# ---------------------------------------------------------------- filters
@pytest.mark.parametrize(
    "shape,sigma",
    [
        ((12, 40, 56), (3.0, 1.0, 1.0)),  # z pad 12 = nz: repeated reflection
        ((5, 33, 47), (3.0, 1.0, 1.0)),  # z pad longer than the axis
        ((2, 6, 30, 30), (0.0, 1.3, 1.3)),  # DoG fine scale, batched
        ((2, 6, 30, 30), (0.0, 2.6, 2.6)),  # DoG coarse scale
    ],
)
def test_gaussian_lowpass_matches_jax(shape, sigma):
    rng = np.random.default_rng(0)
    vol = (rng.random(shape) * 1000).astype(np.float32)
    ref = np.asarray(jfilt.gaussian_lowpass(jnp.asarray(vol), sigma=sigma))
    out = tfilt.gaussian_lowpass(_t(vol), sigma=sigma).numpy()
    # f32 sums in another order: a few ulp of the largest value
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(vol).max())


def test_symmetric_pad_index_is_scipy_reflect():
    for n, r in ((7, 3), (4, 12), (1, 5)):
        idx = tfilt.symmetric_pad_index(n, r, r)
        np.testing.assert_array_equal(np.arange(n)[idx], np.pad(np.arange(n), r, mode="symmetric"))


# ----------------------------------------------------------------- decode
def test_caller_thresholds_and_codebook_match_jax():
    cb = mhd4_codebook()
    assert tdec.caller_thresholds(4) == jdec.caller_thresholds(4)
    np.testing.assert_array_equal(tdec.normalize_codebook(cb), jdec.normalize_codebook(cb))


def _chunk_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    cb = mhd4_codebook(seed=seed)
    traces = (rng.random((16, n)) * 2).astype(np.float32)
    bg = (rng.random(16) * 0.1).astype(np.float32)
    nm = (rng.random(16) + 0.5).astype(np.float32)
    return cb, traces, bg, nm


@pytest.mark.parametrize("path", ["xla", "pallas-interpret"])
def test_decode_chunk_matches_jax(path):
    """K3's plain version vs the JAX XLA path and the Pallas kernel."""
    from jax.experimental.pallas import tpu as pltpu

    cb, traces, bg, nm = _chunk_inputs(1)
    cbt = jdec.normalize_codebook(cb).T.copy()
    args = (jnp.asarray(traces), jnp.asarray(cbt), jnp.asarray(bg), jnp.asarray(nm))
    if path == "xla":
        ref = jdec._decode_chunk_xla(*args)
    else:
        with pltpu.force_tpu_interpret_mode():
            ref = jdec._decode_chunk_pallas(*args, tile_n=512)
    out = tdec.decode_chunk(_t(traces), _t(cbt), _t(bg), _t(nm))
    # f32 reductions in another order: ~1e-6
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-6)
    diff = np.flatnonzero(out[0].numpy() != np.asarray(ref[0]))
    _near_tie_only(diff, traces, cb, bg, nm)


def test_decode_chunk_refuses_bad_input():
    cb, traces, bg, nm = _chunk_inputs(2, n=10)
    cbt = _t(tdec.normalize_codebook(cb).T.copy())
    with pytest.raises(TypeError):
        tdec.decode_chunk(_t(traces).double(), cbt, _t(bg), _t(nm))
    with pytest.raises(ValueError):
        tdec.decode_chunk(_t(traces), cbt, _t(bg[:8]), _t(nm))
    with pytest.raises(ValueError):
        tdec.decode_chunk(_t(np.zeros((40, 10), np.float32)), cbt, _t(bg), _t(nm))
    with pytest.raises(ValueError):
        tdec.decode_chunk_cuda(_t(traces), cbt, _t(bg), _t(nm))


def _volume_case(seed, shape):
    rng = np.random.default_rng(seed)
    cb = mhd4_codebook(seed=seed)
    vol = (rng.random(shape) * 2).astype(np.float32)
    # paint codeword spots so a good share of voxels decode
    for k in range(12):  # through all z: the sigma_z = 3 lowpass keeps them bright
        y, x = (rng.integers(0, s - 4) for s in shape[2:])
        vol[np.flatnonzero(cb[k % len(cb)]), :, y : y + 4, x : x + 5] += 90.0
    bg = np.zeros(16, np.float32)
    nm = np.full(16, 40.0, np.float32)
    return cb, vol, bg, nm


@pytest.mark.parametrize("return_scaled", [True, False])
def test_decode_volume_matches_jax(return_scaled):
    cb, vol, bg, nm = _volume_case(3, (16, 11, 24, 40))  # 11 planes: ragged last z chunk
    lp = np.asarray(jfilt.gaussian_lowpass(jnp.asarray(vol), sigma=(1.0, 1.0, 1.0)))
    ref = jdec.decode_volume(lp, cb, bg, nm, use_pallas=False, return_scaled=return_scaled,
                             **KW)
    out = tdec.decode_volume(lp, cb, bg, nm, return_scaled=return_scaled, device="cpu", **KW)
    assert (out[0] >= 0).mean() > 0.01
    diff = np.flatnonzero(out[0].ravel() != ref[0].ravel())
    _near_tie_only(diff, lp.reshape(16, -1), cb, bg, nm)
    # f16 outputs: one f16 rounding step (<= 1e-3 on values <= 2)
    for r, o in zip(ref[1:3], out[1:3]):
        np.testing.assert_allclose(o.astype(np.float32), r.astype(np.float32), atol=1e-3)
    if return_scaled:
        np.testing.assert_allclose(out[3].astype(np.float32), ref[3].astype(np.float32), atol=1e-3)
    else:
        assert out[3] is None and ref[3] is None


# ------------------------------------------------------------ fused decode
def test_fused_lowpass_decode_matches_pallas_interpret():
    """K1+K2's plain version vs the fused Pallas pipeline, ragged Y and X."""
    from jax.experimental.pallas import tpu as pltpu

    cb, vol, bg, nm = _volume_case(4, (16, 5, 40, 136))
    cbt = tdec.normalize_codebook(cb).T.copy()
    with pltpu.force_tpu_interpret_mode():
        ref = jfused.fused_lowpass_decode(
            jnp.asarray(vol), jnp.asarray(cbt), jnp.asarray(bg), jnp.asarray(nm),
            sigma=(3.0, 1.0, 1.0), **KW,
        )
    out = tfused.fused_lowpass_decode(_t(vol), _t(cbt), _t(bg), _t(nm), sigma=(3.0, 1.0, 1.0), **KW)
    d_ref = np.asarray(ref[0])
    assert (d_ref >= 0).mean() > 0.01
    lp = np.asarray(jfilt.gaussian_lowpass(jnp.asarray(vol), sigma=(3.0, 1.0, 1.0)))
    _near_tie_only(np.flatnonzero(out[0].numpy().ravel() != d_ref.ravel()),
                   lp.reshape(16, -1), cb, bg, nm)
    # the TPU stores bfloat16, the port float16: within bf16 rounding
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r, np.float32),
                                   rtol=2**-7, atol=2e-3)


def test_fused_decode_volume_streaming_gather_matches_jax():
    """Slab streaming with symmetric halos, both packages, on a shape no
    slab divides: the port's slabbed host arrays against the reference's
    foreground gather at the decoded voxels."""
    from jax.experimental.pallas import tpu as pltpu

    cb, vol, bg, nm = _volume_case(5, (16, 4, 44, 140))
    kw = dict(sigma=(0.0, 1.0, 1.0), **KW)
    with pltpu.force_tpu_interpret_mode():
        ref = jfused.fused_decode_volume(vol, cb, bg, nm, y_slab=16, hbm_budget_bytes=0,
                                         scaled_as="gather", **kw)
    whole = tfused.fused_decode_volume(vol, cb, bg, nm, device="cpu", **kw)
    slabbed = tfused.fused_decode_volume(vol, cb, bg, nm, y_slab=16, memory_budget_bytes=0,
                                         device="cpu", **kw)
    # slab streaming reproduces the whole-volume decode exactly
    for s, w in zip(slabbed, whole):
        np.testing.assert_array_equal(s, w)
    lin = np.flatnonzero(whole[0].ravel() >= 0)
    assert lin.size > 100
    lp = np.asarray(jfilt.gaussian_lowpass(jnp.asarray(vol), sigma=kw["sigma"]))
    _near_tie_only(np.flatnonzero(slabbed[0].ravel() != ref[0].ravel()),
                   lp.reshape(16, -1), cb, bg, nm)
    common = np.intersect1d(lin, np.flatnonzero(ref[0].ravel() >= 0))
    # bf16 (TPU) vs f16 (port) storage
    np.testing.assert_allclose(slabbed[3].reshape(16, -1)[:, common].astype(np.float32), ref[3](common),
                               rtol=2**-7, atol=2e-3)
    np.testing.assert_allclose(slabbed[1].astype(np.float32), np.asarray(ref[1], np.float32),
                               rtol=2**-7, atol=2e-3)


def test_fused_lowpass_decode_deep_z_matches_pallas_interpret():
    """More than 64 planes: the reference pads Z and folds its z matrix;
    the port's plain path (and K1's direct z-tap path on the card) take
    any depth."""
    from jax.experimental.pallas import tpu as pltpu

    cb, vol, bg, nm = _volume_case(7, (16, 70, 16, 128))
    cbt = tdec.normalize_codebook(cb).T.copy()
    with pltpu.force_tpu_interpret_mode():
        ref = jfused.fused_lowpass_decode(
            jnp.asarray(vol), jnp.asarray(cbt), jnp.asarray(bg), jnp.asarray(nm),
            sigma=(3.0, 1.0, 1.0), **KW,
        )
    out = tfused.fused_lowpass_decode(_t(vol), _t(cbt), _t(bg), _t(nm), sigma=(3.0, 1.0, 1.0), **KW)
    d_ref = np.asarray(ref[0])
    assert d_ref.shape == (70, 16, 128) and (d_ref >= 0).mean() > 0.01
    lp = np.asarray(jfilt.gaussian_lowpass(jnp.asarray(vol), sigma=(3.0, 1.0, 1.0)))
    _near_tie_only(np.flatnonzero(out[0].numpy().ravel() != d_ref.ravel()),
                   lp.reshape(16, -1), cb, bg, nm)
    # bf16 (TPU) vs f16 (port) storage, as above
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r, np.float32),
                                   rtol=2**-7, atol=2e-3)


def test_fused_wrappers_refuse_bad_input():
    cbt = _t(tdec.normalize_codebook(mhd4_codebook()).T.copy())
    z = torch.zeros(16)
    with pytest.raises(ValueError):
        tfused.fused_lowpass_decode(torch.zeros((16, 8, 8)), cbt, z, z + 1)
    with pytest.raises(ValueError):  # host tensors never reach the kernels
        tfused.x_lowpass_decode_cuda(torch.zeros((16, 4, 8, 8)), cbt, z, z + 1, sigma_x=1.0,
                                     **KW)
    with pytest.raises(ValueError):
        tfused.fused_lowpass_decode(torch.zeros((16, 4, 8, 8)).transpose(2, 3), cbt, z, z + 1)
    with pytest.raises(ValueError):
        tfused.zy_lowpass_cuda(torch.zeros((16, 4, 8, 8)), (1.0, 1.0, 1.0))


def test_z_fold_matrix_is_the_padded_conv():
    k = tfilt._gaussian_kernel1d(3.0)
    r = (len(k) - 1) // 2
    for nz in (1, 5, 12, 16):
        v = np.random.default_rng(nz).random(nz).astype(np.float32)
        padded = np.pad(v, r, mode="symmetric")
        direct = np.array([padded[o : o + len(k)] @ k for o in range(nz)])
        np.testing.assert_allclose(tfused.z_fold_matrix(k, nz) @ v, direct, rtol=1e-5)


# ------------------------------------------------------------ components
def test_component_stats_host_exact():
    """The port's statistics, on tensors labelled by ``label_components``,
    against the JAX package's on its native labels, with dense and
    gathered intensities; the two labellings are the same components in
    the same order."""
    from merfish3d_tpu.native import label_components_sparse as jlabel
    from merfish3d_tpu_torch.ops.components import label_components

    rng = np.random.default_rng(6)
    decoded = np.where(rng.random((6, 30, 30)) < 0.3, rng.integers(0, 5, (6, 30, 30)), -1)
    decoded = decoded.astype(np.int32)
    dist = rng.random(decoded.shape).astype(np.float16)
    mag = rng.random(decoded.shape).astype(np.float16)
    scaled = rng.random((16,) + decoded.shape).astype(np.float32)
    lab_j = jlabel(decoded)
    dec_t = torch.as_tensor(decoded.astype(np.int16))
    lab_t = label_components(dec_t)
    np.testing.assert_array_equal(lab_t[0].numpy(), lab_j[0])
    np.testing.assert_array_equal(np.unique(lab_t[1].numpy(), return_inverse=True)[1],
                                  np.unique(lab_j[1], return_inverse=True)[1])
    out = tcc.component_stats_host(dec_t, lab_t, torch.as_tensor(dist), torch.as_tensor(mag),
                                   torch.as_tensor(scaled))
    lin = lab_j[0]
    for ref_i in (scaled, jcc.SparseIntensity(lin, scaled.reshape(16, -1)[:, lin])):
        ref = jcc.component_stats_host(decoded, lab_j, dist.astype(np.float32),
                                       mag.astype(np.float32), ref_i)
        assert sorted(out) == sorted(ref)
        for key, value in out.items():
            np.testing.assert_array_equal(value, ref[key], err_msg=key)
    np.testing.assert_array_equal(
        tcc.inertia_tensor_eigvals(out["moments"], out["area"]),
        jcc.inertia_tensor_eigvals(ref["moments"], ref["area"]),
    )


def test_greedy_match_matches_native():
    from merfish3d_tpu.native import greedy_match as jmatch
    from merfish3d_tpu_torch.native import greedy_match as tmatch

    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 30, 300)
    dist = rng.random(300)
    np.testing.assert_array_equal(tmatch(src, dst, dist, 40, 30), jmatch(src, dst, dist, 40, 30))
    with pytest.raises(ValueError):
        tmatch(src, dst, dist, 40, 10)


# ------------------------------------------------------------ port sources
def test_port_sources_stand_alone():
    """The port and its smoke import no JAX and nothing of the JAX package,
    and name no path into it: they run where neither is installed."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = [root / "chip_smoke.py", *sorted((root / "merfish3d_tpu_torch").rglob("*.py")),
             *sorted((root / "merfish3d_tpu_torch" / "csrc").glob("*"))]
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|merfish3d_tpu)\b", re.M)
    paths = re.compile(r"""["'/]merfish3d_tpu["'/]|"merfish3d_tpu"|\bmerfish3d_tpu\.(?!\w*torch)""")
    assert len(files) > 20
    scanned = {f.relative_to(root).as_posix() for f in files}
    assert {"merfish3d_tpu_torch/pipeline/chromatic.py",
            "merfish3d_tpu_torch/utils/chromatic_calibration.py",
            "merfish3d_tpu_torch/ops/flow.py"} <= scanned
    for f in files:
        text = f.read_text()
        assert not imports.search(text), f"{f.name} imports JAX or the JAX package"
        code = "\n".join(l for l in text.splitlines() if not l.lstrip().startswith(("#", "//")))
        code = re.sub(r'"""[\s\S]*?"""', "", code)  # docstrings may name the reference
        code = re.sub(r"merfish3d_tpu/[\w/]+\.py:\d+", "", code)  # file:line citations
        assert not paths.search(code), f"{f.name} reaches into merfish3d_tpu/"
