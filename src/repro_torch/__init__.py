"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

It imports ``torch`` and ``numpy`` only (never ``jax`` or ``repro``), keeps
the reference's module names, parameter names and checkpoint format, and
runs on the GPU unless a caller passes ``device="cpu"``.  Its hand-written
CUDA kernels live in :mod:`repro_torch.kernels`.
"""
