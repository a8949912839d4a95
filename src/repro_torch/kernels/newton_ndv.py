"""Batched Newton-Raphson NDV solves: plain PyTorch versions and CUDA wrappers.

Fleet-scale planning runs the paper's two inversions over millions of column
chunks in one pass, one lane per chunk. The solves are fixed-iteration and
branch-free:

  * ``dict_newton``   — invert  S = ndv*len + rows*ceil(log2 ndv)/8   (Eq 2)
  * ``coupon_newton`` — invert  m = D*(1 - exp(-n/D))  in log space   (Eq 8)

Each solve has two implementations with one set of numerics:

  * ``*_math`` — the plain PyTorch version, elementwise over any shape and
    any device. The CPU path runs it; the tests hold it against the JAX
    package; `chip_smoke.py` holds the CUDA kernel against it on the card.
  * the CUDA kernel in ``csrc/newton_ndv.cu``, one thread per lane.

The wrappers ``dict_newton`` / ``coupon_newton`` take flat (M,) float32
tensors. A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel (or raises): there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DICT_ITERS = 16
COUPON_ITERS = 40  # matches repro_torch.core.ndv.minmax_diversity.NEWTON_ITERS
LN2 = 0.6931471805599453


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.ceil(torch.log2(torch.clamp(x, min=1.0)) - 1e-9), min=1.0)


def dict_newton_math(s, rows, nulls, mean_len) -> torch.Tensor:
    """Eq-2 fixed-iteration Newton inversion, elementwise over any shape."""
    non_null = torch.clamp(rows - nulls, min=0.0)
    mean_len = torch.clamp(mean_len, min=1e-6)
    cap = torch.clamp(non_null, min=1.0)

    ndv = torch.minimum(torch.clamp(s / mean_len, min=1.0), cap)
    for _ in range(DICT_ITERS):
        f = ndv * mean_len + non_null * _ceil_log2(ndv) / 8.0 - s
        fp = mean_len + non_null / (8.0 * torch.clamp(ndv, min=1.0) * LN2)
        ndv = torch.minimum(torch.clamp(ndv - f / fp, min=1.0), cap)
    # Plateau snap: solve the linear piece at the converged bit width.
    bits = _ceil_log2(ndv)
    lin = (s - non_null * bits / 8.0) / mean_len
    keep = (_ceil_log2(torch.clamp(lin, min=1.0)) == bits) & (lin >= 1.0)
    return torch.minimum(torch.clamp(torch.where(keep, lin, ndv), min=1.0), cap)


def coupon_newton_math(m, n) -> torch.Tensor:
    """Eq-8 fixed-iteration log-space Newton inversion, elementwise."""
    saturated = m >= n - 0.5
    m_eff = torch.where(saturated, torch.clamp(n - 0.5, min=0.5), m)
    m_eff = torch.minimum(torch.clamp(m_eff, min=0.5), torch.clamp(n - 1e-3, min=0.5))

    t = torch.log(
        torch.clamp(n * n / (2.0 * torch.clamp(n - m_eff, min=1e-3)), 1.0, 1e12)
    )
    for _ in range(COUPON_ITERS):
        ndv = torch.exp(t)
        r = n / torch.clamp(ndv, min=1e-9)
        em1 = -torch.expm1(-r)          # 1 - e^{-r}
        g = ndv * em1 - m_eff
        gp = em1 - torch.exp(-r) * r    # g'(D)
        t = torch.clamp(t - g / torch.clamp(gp * ndv, min=1e-12), 0.0, 28.0)
    ndv = torch.exp(t)
    # Saturated (m == n): the MLE diverges — report the observable m (a hard
    # lower bound), matching repro_torch.core.ndv.minmax_diversity.
    m1 = torch.clamp(m, min=1.0)
    ndv = torch.where(saturated, m1, ndv)
    ndv = torch.where(n <= 0, torch.ones_like(ndv), ndv)
    ndv = torch.where(m_eff <= 0.5001, m1, ndv)
    return torch.maximum(ndv, m1)


def _check_flat(name: str, tensors) -> int:
    m = tensors[0].shape
    for t in tensors:
        if t.dim() != 1 or t.shape != m:
            raise ValueError(f"{name}: expected flat (M,) inputs of one length")
    return int(m[0])


def dict_newton(size, rows, nulls, mean_len) -> torch.Tensor:
    """Batched Eq-2 inversion. Flat (M,) float32 in, (M,) ndv out."""
    ins = [size, rows, nulls, mean_len]
    m = _check_flat("dict_newton", ins)
    if not build.on_cuda("dict_newton", ins):
        return dict_newton_math(*ins)
    dev = build.check_cuda_inputs("dict_newton", ins, [torch.float32] * 4)
    out = torch.empty_like(size)
    if m == 0:
        return out
    lib = build.library("newton_ndv.cu")
    code = lib.dict_newton_launch(
        *(t.data_ptr() for t in ins), out.data_ptr(), m, dev,
        build.stream_handle(dev),
    )
    build.LAUNCHES["dict_newton"] += 1
    build.raise_on_error("dict_newton", code)
    return out


def coupon_newton(m_obs, n_draws) -> torch.Tensor:
    """Batched Eq-8 inversion. Flat (M,) float32 in, (M,) NDV out."""
    ins = [m_obs, n_draws]
    m = _check_flat("coupon_newton", ins)
    if not build.on_cuda("coupon_newton", ins):
        return coupon_newton_math(*ins)
    dev = build.check_cuda_inputs("coupon_newton", ins, [torch.float32] * 2)
    out = torch.empty_like(m_obs)
    if m == 0:
        return out
    lib = build.library("newton_ndv.cu")
    code = lib.coupon_newton_launch(
        m_obs.data_ptr(), n_draws.data_ptr(), out.data_ptr(), m, dev,
        build.stream_handle(dev),
    )
    build.LAUNCHES["coupon_newton"] += 1
    build.raise_on_error("coupon_newton", code)
    return out
