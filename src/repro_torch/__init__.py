"""PyTorch/CUDA port of the model stack, held against the JAX package.

Imports torch, numpy and the standard library only.  Its entry points
(``models.Model``, ``serve.ServeEngine``, ``serve.latency.calibrate``) run
on the GPU unless the caller passes ``device="cpu"``; the kernels under
``kernels/`` are hand-written CUDA C++ for Hopper (sm_90a), built at first
use by ``kernels/_build.py``.
"""
