"""The SHMEM serving stack ported to PyTorch and CUDA for one NVIDIA Hopper
card, beside the JAX package ``repro`` it mirrors module by module.

It imports nothing of JAX or of ``repro``.  Entry points run on the current
CUDA device unless the caller passes ``device="cpu"``; on the CPU every
kernel runs its plain PyTorch version.  The kernels are CUDA C++ under
``csrc/``, built at first use (``kernels/_build.py``).
"""
