"""Plain reference of the benchmarked chain: convert → fiducial round
registration (phase correlation, optional deformable flow) → RLGC on the
readout bits → DoG spot probability → normalization optimization,
lowpass + nearest-codeword decode, component extraction, chromatic
estimate and blank-fraction filter.

Plain PyTorch, numpy and scipy only: no hand-written kernel, no import of
the program under test or of the JAX package. Most modules are frozen
copies of the program's plain (CPU) paths as they stood when the
benchmark was defined; the FFTs run ``torch.fft`` in natural spectrum
order, the RLGC solves one volume at a time, and connected components
come from :mod:`.labels`. Every derived state (PSFs, OTFs, codebook
normalization, thresholds) is worked out here from the raw inputs.

:mod:`.precision` switches the whole reference to its control precision
(bfloat16 storage of every float32 stage result, TF32 matmuls).
"""
