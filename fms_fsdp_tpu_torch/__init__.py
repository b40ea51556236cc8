"""PyTorch port of fms_fsdp_tpu for NVIDIA Hopper (H100).

The JAX package ``fms_fsdp_tpu`` is the reference; this package keeps its
layout and names, so each module's counterpart sits at the same relative
path. It imports ``torch`` and numpy only: nothing of JAX and nothing of
``fms_fsdp_tpu``. Kernels are CUDA C++ under ``csrc/``, built with nvcc
at first use (``ops/cuda_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise. On CPU tensors a
kernel wrapper runs its plain PyTorch version.

Ported so far: Llama serving with paged KV (``serve/``), its ragged
paged-decode kernel (``csrc/paged_decode.cu``), and the model pieces it
runs (``models/``, ``ops/``). ROADMAP.md lists what comes next.
"""
