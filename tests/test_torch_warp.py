"""The port's affine warps (merfish3d_tpu_torch.ops.warp) against the JAX
reference's (merfish3d_tpu.ops.warp) on the same numpy inputs, on CPU.

Tolerance 1e-5 · max|image| on random images. The images are wider than
512 voxels in x, where coordinates rounded by a reduced-precision product
would be off by whole pixels, and every transform moves samples across
every face of the volume, so the constant-mode corner rule is exercised
on all six.

The translate and diagonal classes run at the production voxel size. The
general class sums three products and an offset a coordinate, and XLA on
the CPU contracts some of those into fused multiply-adds that the port's
float32 multiply-adds round separately: one unit in the last place of a
coordinate beyond x = 512 moves a weight by 6e-5, which random data turns
into 6e-5 · max. Its cases therefore take dyadic spacings and matrices,
whose coordinates are exact in float32 under any order of evaluation, so
they hold the taps, weights, corner validity and corner order exactly.
"""

import numpy as np
import pytest
import torch

from merfish3d_tpu.ops import warp as jwarp
from merfish3d_tpu_torch.ops import warp as twarp

SPACING = (0.315, 0.098, 0.098)
DYADIC_SPACING = (0.25, 0.125, 0.125)
SHAPE = (6, 20, 560)


def _image(shape=SHAPE, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 1000.0).astype(np.float32)


def _affine(kind: str) -> np.ndarray:
    """A physical 4x4 of each warp class whose samples straddle every face;
    the general one is dyadic (exact coordinates at DYADIC_SPACING)."""
    t = np.eye(4)
    t[:3, 3] = (0.41, -0.73, 1.9)  # µm: ~1.3 px in z, -7.4 and +19.4 px in y, x
    if kind == "diagonal":
        t[0, 0] = 1.004
        t[1, 1] = t[2, 2] = 0.9982
    elif kind == "general":
        t[:3, 3] = (0.328125, -0.921875, 2.40625)  # 1.3125, -7.375, 19.25 px
        t[1, 1] = t[2, 2] = 1 - 2.0**-9
        t[1, 2], t[2, 1] = 2.0**-9, -(2.0**-10)
        t[0, 2] = 2.0**-10
    return t


def _spacing(kind: str):
    return DYADIC_SPACING if kind == "general" else SPACING


def _close(got: torch.Tensor, want, image: np.ndarray) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(image).max())


@pytest.mark.parametrize("kind", ["translate", "diagonal", "general"])
def test_warp_affine_matches_reference(kind):
    image = _image()
    t = _affine(kind)
    matrix_px, _ = twarp.transform_to_pixel(t, _spacing(kind))
    assert twarp._warp_class(matrix_px) == kind
    kw = dict(transform_zyx_um=t, spacing_zyx_um=_spacing(kind), reference_shape=SHAPE)
    got = twarp.warp_affine(image, device="cpu", **kw)
    _close(got, jwarp.warp_affine(image, **kw), image)
    # the samples left the volume on every face: zero-filled borders
    assert got.dtype == torch.float32 and got.shape == SHAPE


@pytest.mark.parametrize("order", [0, 1])
def test_general_warp_onto_another_grid(order):
    """reference_shape != image.shape takes the general gather whatever
    the matrix; order 0 is nearest-neighbour map_coordinates."""
    image = _image(seed=1)
    kw = dict(transform_zyx_um=_affine("general"), spacing_zyx_um=DYADIC_SPACING,
              reference_shape=(5, 23, 530), order=order, z_chunk=2)
    got = twarp.warp_affine(torch.as_tensor(image), **kw)
    _close(got, jwarp.warp_affine(image, **kw), image)


def test_translation_across_faces_matches_reference():
    """Shifts of a fraction of a voxel past both faces of each axis, in
    both directions: the constant-mode blend with cval."""
    image = _image(shape=(5, 9, 530), seed=2)
    for shift_px in ((-0.5, 8.6, -529.3), (4.5, -0.25, 529.7), (0.0, 0.0, 0.0)):
        t = np.eye(4)
        t[:3, 3] = np.asarray(shift_px) * SPACING
        kw = dict(transform_zyx_um=t, spacing_zyx_um=SPACING, reference_shape=image.shape, cval=3.0)
        _close(twarp.warp_affine(image, device="cpu", **kw), jwarp.warp_affine(image, **kw), image)


def test_warp_batches_match_reference():
    """Mixed classes (identity, translate, diagonal, general) through both
    batched forms against the reference's batched warp (dyadic spacing,
    so the diagonal and translate classes are exact too)."""
    images = np.stack([_image(seed=s) for s in range(5)])
    transforms = np.stack([np.eye(4), _affine("translate"), _affine("diagonal"), _affine("general"),
                           _affine("diagonal")]).astype(np.float32)
    classes = twarp._affine_batch_classes(transforms, DYADIC_SPACING, 5)[2]
    assert [list(idx) for idx, _ in classes] == [[0, 1], [2, 4], [3]]
    want = jwarp.warp_affine_batch(images, transforms, DYADIC_SPACING)
    got = twarp.warp_affine_batch_device(torch.as_tensor(images), transforms, DYADIC_SPACING)
    _close(got, want, images)
    host = twarp.warp_affine_batch(images, transforms, DYADIC_SPACING,
                                   hbm_budget_bytes=2 * images[0].nbytes, device="cpu")
    np.testing.assert_array_equal(host, got.numpy())
    assert [list(s) for s in twarp._sub_batches(5, 10, 40, live_per_item=2)] == [[0, 2], [2, 4], [4, 5]]


def test_transform_points_to_reference_matches():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 100, (40, 3))
    t = _affine("general")
    np.testing.assert_array_equal(twarp.transform_points_to_reference(pts, t),
                                  jwarp.transform_points_to_reference(pts, t))
