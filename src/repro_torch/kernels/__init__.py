"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each with
its wrapper, its plain PyTorch version and its launch count."""
