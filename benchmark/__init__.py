"""Benchmark of the PyTorch/CUDA port (``merfish3d_tpu_torch``): the
production MERFISH tile through registration, RLGC, flow and decode.
Run a cell with ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
