"""Dispatch for the NDV kernels: the ``backend`` and ``fuse`` knobs.

``backend`` picks the numerics of the estimator stages:

  "auto"  the kernel path. The kernels' fixed-iteration numerics, run by the
          CUDA kernels for CUDA tensors and by their plain PyTorch versions
          for CPU tensors (the wrappers decide by the tensor's device).
  "cuda"  the kernel path, and the tensors must be on a CUDA device: a CPU
          tensor raises instead of running the plain version.
  "ref"   the reference numerics: the estimator modules' own Newton loops
          that stop at a tolerance, with no kernel.

``fuse`` ("auto" | "on" | "off") picks between the per-stage path and one
fused launch. This slice has no fused kernel, so "auto" resolves to the
per-stage path on every device. "on" runs the reference pipeline in one call
(`ref.ref_fused_estimate`) on the CPU or with ``backend="ref"``; with a CUDA
tensor and a kernel backend it raises `NotImplementedError`, since the fused
CUDA kernel is ROADMAP Queue B item 1 and nothing else may stand in for it.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import minmax_scan as _mm
from repro_torch.kernels import newton_ndv as _newton
from repro_torch.kernels import ref as _ref

Backend = Literal["auto", "cuda", "ref"]
BACKENDS = ("auto", "cuda", "ref")
FUSE_MODES = ("auto", "on", "off")


def use_kernels(backend: Backend) -> bool:
    """Whether the estimator stages take the kernel path (vs "ref")."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend != "ref"


def cache_token(backend: Backend, device_type: str) -> str:
    """Numerics identity of a backend on a device type.

    The kernel path is "t.cuda" (the CUDA kernels) or "t.cpu" (their plain
    versions); the reference numerics are "t.ref.cuda" or "t.ref.cpu". The
    device is part of it because the CUDA and CPU math libraries differ in
    the last ulp, which can flip a clamp bit (ROADMAP Queue C item 2).
    """
    return f"t.{device_type}" if use_kernels(backend) else f"t.ref.{device_type}"


def use_fused(fuse: str) -> bool:
    """Resolve `EngineConfig.fuse`: only "on" fuses in this slice."""
    if fuse not in FUSE_MODES:
        raise ValueError(f'fuse must be "auto", "on", or "off", got {fuse!r}')
    return fuse == "on"


def _check_device(backend: Backend, name: str, x: torch.Tensor) -> None:
    if backend == "cuda" and x.device.type != "cuda":
        raise RuntimeError(
            f'{name}: backend="cuda" needs CUDA tensors, got a tensor on {x.device}'
        )


def fused_estimate(batch, schema_bound=None, *, mode: str = "paper",
                   backend: Backend = "auto"):
    """The §4-§7 pipeline in one call: the reference core, never a kernel.

    With a CUDA batch and a kernel backend this raises: the fused CUDA kernel
    is the next slice of the port (ROADMAP Queue B item 1).
    """
    if use_kernels(backend):
        _check_device(backend, "fused_estimate", batch.chunk_S)
        if batch.device.type == "cuda":
            raise NotImplementedError(
                'fuse="on" needs the fused estimation kernel on CUDA, which is '
                "not ported yet (ROADMAP Queue B item 1); use fuse=\"off\" or "
                '"auto"'
            )
    return _ref.ref_fused_estimate(batch, schema_bound, mode=mode)


def dict_newton(size, rows, nulls, mean_len, *, backend: Backend = "auto"):
    """Batched Eq-2 dictionary-size inversion (flat float32 tensors)."""
    if not use_kernels(backend):
        return _ref.ref_dict_newton(size, rows, nulls, mean_len)
    _check_device(backend, "dict_newton", size)
    return _newton.dict_newton(size, rows, nulls, mean_len)


def coupon_newton(m_obs, n_draws, *, backend: Backend = "auto"):
    """Batched Eq-8 coupon-collector inversion (flat float32 tensors)."""
    if not use_kernels(backend):
        return _ref.ref_coupon_newton(m_obs, n_draws)
    _check_device(backend, "coupon_newton", m_obs)
    return _newton.coupon_newton(m_obs, n_draws)


def minmax_scan(mins, maxs, valid, *, backend: Backend = "auto"):
    """Detector metric reductions over (B, R) row-group statistics."""
    if not use_kernels(backend):
        # The reductions are exact apart from the order of one float sum, so
        # the plain version is also the reference (the "ref" detector's).
        return _mm.minmax_metrics_math(mins, maxs, valid)
    _check_device(backend, "minmax_scan", mins)
    return _mm.minmax_scan(mins, maxs, valid)
