"""Kernels of the port: hand-written CUDA (``cuda_kernels``, and the
norm backwards in ``fused_norms``, all built by ``cuda_build``) and
Triton (the norm forwards in ``fused_norms``), each beside its plain
PyTorch version; ``kernel_registry`` is the table of all of them.
``activations`` and ``losses`` are plain torch functions."""
