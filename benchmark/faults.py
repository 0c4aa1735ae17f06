"""Faults planted in the timed path, each of which the check has to
catch: used by the fault tests (small tiles on the CPU) and by
``calibrate.py --fault`` (the cell's own size on the card). Each is a
context manager that patches one attribute of the program and restores
it."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


@contextmanager
def _patched(owner, name: str, make):
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def registration_unchanged():
    """A step that returns its state unchanged: every moving round left
    where it was."""
    from merfish3d_tpu_torch.pipeline import registration

    def make(inner):
        def unchanged(fixed, movings, *, spacing_zyx_um, return_warped=False, device="cuda", **kw):
            movings = torch.as_tensor(movings, device=device)
            return np.tile(np.eye(4, dtype=np.float32), (len(movings), 1, 1)), movings.to(torch.uint16)
        return unchanged
    return _patched(registration, "register_rounds_to_fixed", make)


def rlgc_unchanged():
    """A step that returns its state unchanged: the solve hands back the
    raw counts."""
    from merfish3d_tpu_torch.pipeline import registration

    def make(inner):
        def unchanged(images, psf, **kw):
            out = torch.as_tensor(images).to(torch.float32)
            return (out, [0] * len(out)) if kw.get("return_iters") else out
        return unchanged
    return _patched(registration, "rlgc_batch", make)


def fiducial_rlgc_unchanged():
    """A step that returns its state unchanged: every fiducial solve (round
    0's single solve through ``chunked_rlgc`` and the moving rounds' batch
    solves) hands back the raw counts; the readout solves run as they are."""
    from merfish3d_tpu_torch.pipeline import registration

    def raw(images, psf, **kw):
        out = torch.as_tensor(images).to(torch.float32)
        return (out, [0] * len(out)) if kw.get("return_iters") else out

    def make(inner):
        def unchanged(self, tile):
            with _patched(registration, "rlgc_batch", lambda _: raw), \
                    _patched(registration, "chunked_rlgc", lambda _: raw):
                return inner(self, tile)
        return unchanged
    return _patched(registration.DataRegistration, "_generate_registrations", make)


def half_the_bits():
    """Half of the batch left out, the mean taken over the rest: the
    second half of the decode's bit stack replaced by the first half's
    mean."""
    from merfish3d_tpu_torch.pipeline import decode_warping

    def make(inner):
        def half(images, **kw):
            out = inner(images, **kw).clone()
            h = out.shape[0] // 2
            out[h:] = out[:h].mean(dim=0, keepdim=True)
            return out
        return half
    return _patched(decode_warping, "warp_bit_images_to_reference", make)


def altered_answer():
    """An answer altered where it is produced: one decoded barcode of the
    final table given another gene."""
    from merfish3d_tpu_torch.pipeline import decoder

    def make(inner):
        def altered(self, **kw):
            table = inner(self, **kw)
            genes = np.asarray(table["gene_id"], dtype=object).copy()
            genes[len(genes) // 2] = "gene000" if genes[len(genes) // 2] != "gene000" else "gene001"
            table["gene_id"] = genes
            return table
        return altered
    return _patched(decoder.PixelDecoder, "decode_all_tiles", make)


FAULTS = {f.__name__: f for f in (registration_unchanged, rlgc_unchanged, fiducial_rlgc_unchanged, half_the_bits,
                                  altered_answer)}
