"""PyTorch/CUDA port of the model stack, held against the JAX package.

Imports torch, numpy and the standard library only.  Its entry points
(``models.Model``, ``serve.ServeEngine``, ``serve.latency.calibrate``) run
on the GPU unless the caller passes ``device="cpu"``; the kernels under
``kernels/`` are hand-written CUDA C++ for Hopper (sm_90a), built at first
use by ``kernels/_build.py``.  ``core/`` is the scheduler (A-SRPT and its
simulator), the JAX package's numpy code copied so that its schedules are
the reference's bit for bit; the card reaches it through the serving
latency curve that ``serve.latency.calibrate`` measures.  ``analysis/`` is
the reference's determinism linter, copied likewise, which lints ``core/``.
"""
