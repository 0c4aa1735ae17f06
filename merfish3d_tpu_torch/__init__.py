"""PyTorch/CUDA port of merfish3d_tpu: fiducial round registration, RLGC
deconvolution, U-FISH spot prediction and the decode stage.

A second package beside :mod:`merfish3d_tpu` (the JAX reference, which
this package never imports). It runs the hermetic single-tile chain —
generate → convert → fiducial round registration (phase correlation) →
RLGC deconvolution → per-bit spot probability (the U-FISH CNN or DoG) →
normalization optimization → lowpass + nearest-codeword decode →
component extraction → blank-fraction filter → F1 — on in-memory arrays
with torch, numpy, scipy and the standard library only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU. On a CUDA tensor the hot paths launch the hand-written
Hopper kernels in ``csrc/`` (built with ``nvcc`` at first use, see
:mod:`._build`); on a CPU tensor they run their plain torch versions.
"""

import torch

# Full-f32 convolutions and matmuls: cuDNN convolutions default to TF32
# (~3 decimal digits), which would put every plain lowpass on the card
# outside the decode tolerances.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
