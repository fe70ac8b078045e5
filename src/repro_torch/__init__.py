"""PyTorch / CUDA port of ``repro``: the same system for an NVIDIA H100.

Sub-packages mirror ``repro`` one to one, so the twin of ``repro/x/y.py``
is ``repro_torch/x/y.py``. This package imports ``torch`` and ``numpy``
only; the kernels under ``csrc/`` are CUDA C++ built at first use by
``repro_torch.kernels._build``.
"""
