"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``), the wrappers that dispatch between them (``ops``) and the
build that compiles ``csrc/*.cu`` (``_build``)."""
