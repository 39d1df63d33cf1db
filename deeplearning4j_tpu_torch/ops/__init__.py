"""Kernels of the port: hand-written CUDA (``cuda_kernels``, built by
``cuda_build``) and Triton (``fused_norms``), each beside its plain
PyTorch version; ``kernel_registry`` is the table of all of them."""
