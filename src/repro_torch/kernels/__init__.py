"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their wrappers and
their plain PyTorch versions.  Importing this package builds nothing: the
kernels are compiled at their first launch (``_build.load_library``)."""
