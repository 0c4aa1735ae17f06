"""The port's affine + flow warps (merfish3d_tpu_torch.ops.warp) against
the JAX reference's (merfish3d_tpu.ops.warp) on the same numpy inputs,
on CPU.

Tolerance 1e-5 · max|image|. XLA on the CPU contracts some of the
reference's multiply-adds into fused multiply-adds that the port rounds
twice (`ROADMAP.md` §3). The separable path takes random flows at the
production voxel size: its taps are integers and its hat weights see such
a difference at ulp size. The gather path samples the image at the
displaced coordinate, where one ulp beyond x = 512 moves a weight by
6e-5; its cases therefore take dyadic spacings, matrices, lattices and
flows (flow values on a 1/4 grid; a stride of 2 from integer box starts
puts the lattice coordinates on a 1/2 grid), whose coordinates are exact
in float32 under any order of evaluation.
"""

import numpy as np
import pytest
import torch

from merfish3d_tpu.ops import warp as jwarp
from merfish3d_tpu_torch.ops import warp as twarp

SPACING = (0.315, 0.098, 0.098)
DYADIC_SPACING = (0.25, 0.125, 0.125)
SHAPE = (6, 20, 560)
DYADIC_STRIDE = (2.0, 2.0, 2.0)
DYADIC_LATTICE = (3, 10, 280)


def _image(shape=SHAPE, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) * 1000.0).astype(np.float32)


def _flow(seed=1, lattice=(3, 4, 40), dyadic=False) -> np.ndarray:
    if dyadic:
        lattice = DYADIC_LATTICE
    flow = np.random.default_rng(seed).normal(0.0, 1.5, (3, *lattice))
    return (np.round(flow * 4) / 4 if dyadic else flow).astype(np.float32)


def _affine(kind: str) -> np.ndarray:
    t = np.eye(4)
    if kind == "identity":
        return t
    t[:3, 3] = (0.328125, -0.921875, 2.40625)  # 1.3125, -7.375, 19.25 px at DYADIC_SPACING
    if kind == "diagonal":
        t[0, 0] = 1.004
        t[1, 1] = t[2, 2] = 0.9982
    elif kind == "dyadic-diagonal":
        t[1, 1] = t[2, 2] = 1 - 2.0**-6
    elif kind == "general":
        t[1, 1] = t[2, 2] = 1 - 2.0**-6
        t[1, 2], t[2, 1] = 2.0**-6, -(2.0**-7)
        t[0, 2] = 2.0**-8
    return t


def _close(got: torch.Tensor, want, image: np.ndarray) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(image).max())


def _both(image, flow, method, transform, spacing, stride, box):
    kw = dict(transform_zyx_um=transform, spacing_zyx_um=spacing, reference_shape=image.shape,
              map_stride_zyx_px=stride, map_box_start_xyz_px=box, method=method)
    want = np.asarray(jwarp.warp_affine_plus_flow(image, flow, **kw))
    got = twarp.warp_affine_plus_flow(image, flow, device="cpu", **kw)
    return got, want


def test_upsample_and_variable_shift_match_reference():
    import jax.numpy as jnp

    flow = _flow()
    stride = np.asarray((2.0, 6.0, 14.0), np.float32)
    box = np.asarray((3.0, 4.0, 1.5), np.float32)
    want = jwarp._upsample_flow_channel(jnp.asarray(flow[1]), out_shape=SHAPE, stride_zyx=jnp.asarray(stride),
                                        box_start_zyx=jnp.asarray(box))
    got = twarp._upsample_flow_channel(torch.as_tensor(flow[1]), out_shape=SHAPE, stride_zyx=stride,
                                       box_start_zyx=box)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * np.abs(flow).max())
    image = _image()
    shift = np.asarray(want) + 0.3
    for axis in range(3):
        k0, k1 = int(np.floor(shift.min())), int(np.floor(shift.max())) + 1
        want_s = jwarp._variable_shift_axis(jnp.asarray(image), jnp.asarray(shift), axis, k0, k1)
        got_s = twarp._variable_shift_axis(torch.as_tensor(image), torch.as_tensor(shift), axis, k0, k1)
        _close(got_s, want_s, image)


@pytest.mark.parametrize("case", ["finite", "general", "infinite", "over-cap", "scaled"])
def test_separable_flow_bounds_exact(case):
    flow = _flow()
    matrix, offset = np.eye(3, dtype=np.float32), np.asarray((0.3, -2.7, 5.2), np.float32)
    if case == "general":
        matrix[1, 2] = 1e-3
    elif case == "infinite":
        flow[0, 1, 1, 1] = np.inf
    elif case == "over-cap":
        flow[2] *= 40.0
    elif case == "scaled":
        matrix = np.diag([1.004, 0.9982, 0.9982]).astype(np.float32)
    want = jwarp._separable_flow_bounds(matrix, offset, flow, SHAPE)
    assert twarp._separable_flow_bounds(matrix, offset, flow, SHAPE) == want
    assert (want is None) == (case in ("general", "infinite", "over-cap"))


@pytest.mark.parametrize("kind", ["identity", "diagonal"])
def test_separable_path_matches_reference(kind):
    image, flow = _image(), _flow()
    got, want = _both(image, flow, "separable", _affine(kind), SPACING, (2.0, 6.0, 14.0), (1.5, 4.0, 3.0))
    _close(got, want, image)


@pytest.mark.parametrize("kind", ["identity", "dyadic-diagonal", "general"])
def test_gather_path_matches_reference(kind):
    image, flow = _image(), _flow(dyadic=True)
    got, want = _both(image, flow, "gather", _affine(kind), DYADIC_SPACING, DYADIC_STRIDE, (1.0, 4.0, 3.0))
    _close(got, want, image)


def test_gather_onto_another_grid_matches_reference():
    """An image of another shape than the reference grid takes the gather."""
    image, flow = _image((5, 24, 530)), _flow(dyadic=True)
    kw = dict(transform_zyx_um=_affine("general"), spacing_zyx_um=DYADIC_SPACING, reference_shape=SHAPE,
              map_stride_zyx_px=DYADIC_STRIDE, map_box_start_xyz_px=(1.0, 4.0, 3.0))
    want = np.asarray(jwarp.warp_affine_plus_flow(image, flow, **kw))
    got = twarp.warp_affine_plus_flow(image, flow, device="cpu", **kw)
    assert tuple(got.shape) == SHAPE
    _close(got, want, image)
    with pytest.raises(ValueError):
        twarp.warp_affine_plus_flow(image, flow, device="cpu", method="separable", **kw)


@pytest.mark.parametrize("method", ["separable", "gather"])
def test_zero_flow_equals_warp_affine(method):
    image = _image()
    transform = _affine("dyadic-diagonal")
    got = twarp.warp_affine_plus_flow(
        image, np.zeros((3, 3, 4, 40), np.float32), transform_zyx_um=transform, spacing_zyx_um=DYADIC_SPACING,
        reference_shape=SHAPE, map_stride_zyx_px=(2.0, 6.0, 14.0), map_box_start_xyz_px=(1.5, 4.0, 3.0),
        method=method, device="cpu",
    )
    want = twarp.warp_affine(torch.as_tensor(image), transform_zyx_um=transform, spacing_zyx_um=DYADIC_SPACING,
                             reference_shape=SHAPE)
    _close(got, want, image)


def test_constant_flow_case_matches_reference():
    """The reference's constant-flow case (tests/test_registration.py): a
    +2 px X flow equals a +2 px X pull, and the port equals the reference."""
    zz, yy, xx = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in (12, 48, 48)], indexing="ij")
    vol = np.zeros((12, 48, 48), np.float32)
    for c in ((5, 20, 18), (7, 30, 28), (4, 12, 35)):
        vol += 1000.0 * np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / 8.0)
    flow = np.zeros((3, 4, 8, 8), np.float32)
    flow[0] = 2.0
    shift = np.eye(4, dtype=np.float32)
    shift[2, 3] = 2.0 * SPACING[2]
    kw = dict(transform_zyx_um=np.eye(4, dtype=np.float32), spacing_zyx_um=SPACING, reference_shape=vol.shape,
              map_stride_zyx_px=(4.0, 8.0, 8.0), map_box_start_xyz_px=(4.0, 4.0, 2.0))
    want = np.asarray(jwarp.warp_affine_plus_flow(vol, flow, **kw))
    got = twarp.warp_affine_plus_flow(vol, flow, device="cpu", **kw)
    _close(got, want, vol)
    pulled = twarp.warp_affine(torch.as_tensor(vol), transform_zyx_um=shift, spacing_zyx_um=SPACING,
                               reference_shape=vol.shape)
    interior = (slice(1, -1), slice(4, -4), slice(4, -4))
    np.testing.assert_allclose(got.numpy()[interior], pulled.numpy()[interior], atol=0.5)


@pytest.mark.parametrize("route", ["separable", "gather"])
def test_flow_batches_match_single_and_reference(route, monkeypatch):
    """Both batch forms item for item against the single warp and the
    reference's batch, per-item flows, lattices and transforms; the
    device form in groups of one (budget shrunk) and whole."""
    n = 3
    dyadic = route == "gather"
    images = np.stack([_image(seed=s) for s in range(n)])
    flows = np.stack([_flow(seed=10 + s, dyadic=dyadic) for s in range(n)])
    if route == "gather":
        flows[1, 0] *= 60.0  # past the term cap: every item takes the gather
    kinds = ["identity", "dyadic-diagonal", "dyadic-diagonal"] if dyadic else ["identity", "diagonal", "identity"]
    transforms = np.stack([_affine(k) for k in kinds])
    spacing = DYADIC_SPACING if dyadic else SPACING
    strides = np.asarray([DYADIC_STRIDE if dyadic else (2.0, 6.0, 14.0)] * n, np.float32)
    boxes = np.asarray([(1.0, 4.0, 3.0), (3.0, 2.0, 1.0), (1.0, 4.0, 3.0)], np.float32)
    args = (flows, transforms, spacing, strides, boxes)
    want = np.asarray(jwarp.warp_affine_plus_flow_batch(images, *args))
    host = twarp.warp_affine_plus_flow_batch(images, *args, hbm_budget_bytes=images[0].nbytes * 6, device="cpu")
    whole = twarp.warp_affine_plus_flow_batch_device(torch.as_tensor(images), *args)
    monkeypatch.setattr(twarp, "_FLOW_WARP_BUDGET_BYTES", images[0].nbytes * twarp._FLOW_WARP_LIVE_PER_ITEM)
    grouped = twarp.warp_affine_plus_flow_batch_device(torch.as_tensor(images), *args)
    np.testing.assert_array_equal(grouped.numpy(), whole.numpy())
    np.testing.assert_array_equal(host, whole.numpy())
    for i in range(n):
        _close(whole[i], want[i], images)
    merged = twarp._flow_batch_plan(transforms, spacing, flows, SHAPE)[2]
    assert (merged is None) == (route == "gather")
    if route == "separable":
        # an item warped alone takes its own narrower roll range: the same
        # values up to the ulps of the extra zero-weight terms
        for i in range(n):
            single = twarp.warp_affine_plus_flow(
                images[i], flows[i], transform_zyx_um=transforms[i], spacing_zyx_um=spacing,
                reference_shape=SHAPE, map_stride_zyx_px=strides[i], map_box_start_xyz_px=boxes[i], device="cpu",
            )
            _close(single, whole[i].numpy(), images)
    else:
        for i in range(n):
            single = twarp.warp_affine_plus_flow(
                images[i], flows[i], transform_zyx_um=transforms[i], spacing_zyx_um=spacing,
                reference_shape=SHAPE, map_stride_zyx_px=strides[i], map_box_start_xyz_px=boxes[i],
                method="gather", device="cpu",
            )
            np.testing.assert_array_equal(single.numpy(), whole[i].numpy())
