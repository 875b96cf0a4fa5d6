"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package imports nothing
of it (and never imports ``jax``).  Entry points take ``device=`` and default
to ``"cuda"``; the CPU tests pass ``device="cpu"``.  Module names mirror
``repro``'s, so each file's counterpart is found under the same path there.
"""
