"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The port mirrors the JAX package's module paths, so each module here has
one counterpart there (``zoo/gpt.py`` ports ``deeplearning4j_tpu/zoo/
gpt.py`` and so on). It imports ``torch`` only: never ``jax``, never the
JAX package.

The first slice serves a ``CausalTransformerLM`` through the
continuous-batching gateway:

- ``serving.gateway.ServingGateway`` — submit/stream/result front end;
- ``serving.scheduler.DecodeScheduler`` — paged single-token decode step
  and dense prefill admission;
- ``serving.kv_pager.KVPager`` — the paged KV pool and its bookkeeping;
- ``zoo.gpt`` — the model's prefill and decode math;
- ``ops.cuda_kernels.flash_attention`` (CUDA C++, ``csrc/``) and
  ``ops.fused_norms.rms_norm`` (Triton) — the two hand-written Hopper
  kernels the path runs, with their plain PyTorch versions.

Importing the package (or any module in it) initialises no CUDA
context, imports no ``triton`` and builds no kernel: kernels are built
at their first launch.
"""
