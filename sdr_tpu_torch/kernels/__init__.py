"""Hand-written CUDA kernels for Hopper and their plain torch versions.

Each kernel module holds the wrapper (CUDA tensors: launch or raise),
the plain version (CPU tensors, the tests, and the comparisons on the
card) and its shape predicate. ``_lib`` builds and binds the library.
"""
