"""Hand-written CUDA kernels for metadata-only NDV estimation (Hopper).

How an estimate call reaches the card::

    estimate_batch (core/ndv/estimator.py)
      |  ops.use_fused(fuse)?            fuse: "auto" | "on" | "off"
      |-- "on"  -> ops.fused_estimate: the reference core in one call on the
      |            CPU or with backend="ref"; NotImplementedError on CUDA
      |            with a kernel backend (the fused kernel is the next slice)
      +-- else  -> estimate_batch_core, which dispatches per stage through
            ops.minmax_scan   -> minmax_scan.py  (csrc/minmax_scan.cu)
            ops.dict_newton   -> newton_ndv.py   (csrc/newton_ndv.cu)
            ops.coupon_newton -> newton_ndv.py   (csrc/newton_ndv.cu)
          each resolving kernel path vs reference numerics via
          ops.use_kernels(backend)

Each kernel module is layered the same way:

  * ``*_math`` — the plain PyTorch version of the kernel's numerics, run for
    CPU tensors and used as the kernel's yardstick on the card;
  * the wrapper — checks device, dtype, shape and contiguity, launches the
    CUDA kernel for CUDA tensors on the current stream (counting the launch
    in ``build.LAUNCHES``), and raises if the launch fails;
  * ``csrc/*.cu`` — the kernel, built with nvcc for sm_90a on first use
    (``build.py``) and called through ctypes;
  * ``ref.py`` — the reference-numerics oracles (``backend="ref"``).
"""
from repro_torch.kernels import ops  # noqa: F401
