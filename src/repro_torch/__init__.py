"""repro_torch: zero-cost NDV estimation from columnar file metadata, in
PyTorch with hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package `repro`, module for module at the same relative
paths. It imports torch and never JAX or `repro`; the JAX package stays the
reference that the tests hold the port against.
"""
__version__ = "0.1.0"
