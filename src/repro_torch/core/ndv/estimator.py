"""Top-level zero-cost NDV estimator (paper §3-§7 end to end).

`estimate_batch` is the per-batch program: metadata tensors in, estimates
out, on whatever device the tensors lie on, with no knowledge of batch
budgets. Execution — local vs chunked, the device, and the kernel backend
knob — is owned by `repro_torch.engine.EstimationEngine`, which the catalog
routes through.

Pipeline per column (all batched over B columns x R chunks):
  1. distribution detection from (min_i, max_i) patterns         (§6)
  2. PER-CHUNK dictionary size inversion w/ fallback detection,
     aggregated across chunks by masked max                      (§4)
  3. min/max diversity via coupon-collector inversion            (§5)
  4. hybrid combination + type/schema bounds                     (§7)

Why max-aggregation for §4: each chunk's dictionary holds the distinct
values OF THAT CHUNK, so a chunk inversion lower-bounds the global NDV. When
values are well-spread, every chunk sees nearly all distinct values and the
max is tight; when sorted, each chunk sees ~NDV/n values and the max
underestimates — exactly the complementarity of paper Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.ndv import combine as combine_mod
from repro_torch.core.ndv import dict_inversion, distribution, improved, minmax_diversity
from repro_torch.core.ndv.types import ColumnBatch, Layout, NDVEstimate


class BatchEstimates(NamedTuple):
    """Struct-of-arrays estimation output for B columns.

    The trailing provenance fields (route onward) are per-lane diagnostics
    of HOW each estimate was produced. They are emitted by the same
    pipeline body as the estimates themselves — every engine strategy — so
    they obey the identical parity contract, and they never enter cache
    keys.
    """

    ndv: torch.Tensor
    ndv_dict: torch.Tensor
    ndv_minmax: torch.Tensor
    layout: torch.Tensor
    is_lower_bound: torch.Tensor
    confidence: torch.Tensor
    overlap_ratio: torch.Tensor
    monotonicity: torch.Tensor
    mean_len: torch.Tensor
    dict_iterations: torch.Tensor
    route: torch.Tensor             # int32 — combine.ROUTE_DICT / ROUTE_MINMAX
    route_margin: torch.Tensor      # float32 in [0, 1) — Eq 13 decisiveness
    detector_margin: torch.Tensor   # float32 — distance to nearest §6 threshold
    dict_residual: torch.Tensor     # float32 — worst normalized Eq 2 residual
    coupon_iterations: torch.Tensor  # int32 — §5 Newton iters, winning side
    clamp_flags: torch.Tensor       # int32 — combine.CLAMP_* bounds that bit


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def dict_estimate_column(
    batch: ColumnBatch,
    *,
    backend: str = "auto",
) -> tuple:
    """§4 per-chunk inversion -> (ndv_dict, likely_fallback, iters, residual).

    Chunks whose writer-recorded encoding is plain are excluded from the max
    (their S does not obey Eq 1); if ALL chunks of a column are plain, the
    column-level fallback flag is raised and ndv_dict falls back to the
    plain-size implied bound S/len ~ rows (a lower-bound signal).

    ``residual`` is the worst |Eq 2 residual| / S across the column's valid
    chunks at the converged roots — the solver's own error signal, surfaced
    for provenance (a large value means Eq 1 never fit that chunk's size).
    """
    inv = dict_inversion.invert_dict_size(
        batch.chunk_S,
        batch.chunk_rows,
        batch.chunk_nulls,
        batch.mean_len[:, None],
        backend=backend,
    )
    usable = batch.valid & batch.chunk_dict_encoded & ~inv.likely_fallback
    ndv_usable = torch.where(usable, inv.ndv, -1.0).amax(dim=-1)
    # Fallback path: no usable dictionary chunk -> max over ALL valid chunks
    # (plain chunks invert to ~rows; Eq 5 semantics: a lower bound).
    ndv_any = torch.where(batch.valid, inv.ndv, -1.0).amax(dim=-1)
    no_usable = ndv_usable < 0.0
    ndv_col = torch.clamp(torch.where(no_usable, ndv_any, ndv_usable), min=1.0)
    iters = torch.where(batch.valid, inv.iterations, 0).amax(dim=-1).to(torch.int32)
    chunk_non_null = torch.clamp(batch.chunk_rows - batch.chunk_nulls, min=0.0)
    resid = torch.abs(
        dict_inversion.residual(
            inv.ndv, batch.chunk_S, batch.mean_len[:, None], chunk_non_null
        )
    ) / torch.clamp(batch.chunk_S, min=1.0)
    resid = torch.where(batch.valid, resid, 0.0).amax(dim=-1)
    return ndv_col, no_usable, iters, resid.to(torch.float32)


def estimate_batch_core(
    batch: ColumnBatch,
    schema_bound: Optional[torch.Tensor] = None,
    *,
    mode: str = "paper",
    backend: str = "auto",
) -> BatchEstimates:
    """The §4-§7 pipeline body: ColumnBatch tensors in, estimates out.

    With ``backend="ref"`` it is also what ``fuse="on"`` runs
    (`repro_torch.kernels.ref.ref_fused_estimate`).
    """
    if mode not in ("paper", "improved"):
        raise ValueError(f'mode must be "paper" or "improved", got {mode!r}')
    # --- §6: distribution detection --------------------------------------
    metrics = distribution.detect_distribution(
        batch.mins, batch.maxs, batch.valid, backend=backend
    )

    # --- §4: dictionary size inversion (per chunk -> column aggregate) ----
    if mode == "improved":
        imp = improved.improved_dict_estimate(
            batch, metrics.overlap_ratio, backend=backend
        )
        ndv_dict, likely_fallback = imp.ndv, imp.likely_fallback
        _, _, dict_iters, dict_resid = dict_estimate_column(
            batch, backend=backend
        )
    else:
        ndv_dict, likely_fallback, dict_iters, dict_resid = (
            dict_estimate_column(batch, backend=backend)
        )

    # --- §5: min/max diversity --------------------------------------------
    n_f = batch.n_groups.to(torch.float32)
    mm = minmax_diversity.estimate_minmax_diversity(
        batch.m_min, batch.m_max, n_f, backend=backend,
    )

    # --- §7: combine -------------------------------------------------------
    big = 3.4e38
    gmin = torch.where(batch.valid, batch.mins, big).amin(dim=-1)
    gmax = torch.where(batch.valid, batch.maxs, -big).amax(dim=-1)
    non_null = batch.N - batch.nulls
    # Clustered signature: range overlap says "well-spread" while the
    # extrema diversity saturates — runs are hiding the domain tail.
    suspect_clustered = (
        (metrics.layout == int(Layout.WELL_SPREAD))
        & mm.saturated
        & (n_f >= 8.0)
    ) if mode == "improved" else None
    comb = combine_mod.combine_estimates(
        ndv_dict,
        mm.ndv,
        non_null=non_null,
        layout=metrics.layout,
        likely_fallback=likely_fallback,
        minmax_saturated=mm.saturated,
        int_like=batch.int_like,
        gmin=gmin,
        gmax=gmax,
        single_byte=batch.single_byte,
        len_sample=batch.len_sample,
        schema_bound=schema_bound,
        suspect_clustered=suspect_clustered,
    )
    # Detector margin: distance of the (overlap, monotonicity) metrics to
    # the NEAREST §6 classification threshold. A small margin means the
    # layout class — and with it the aggregation route — was a near-tie.
    ov, mono = metrics.overlap_ratio, metrics.monotonicity
    detector_margin = torch.minimum(
        torch.minimum(
            torch.minimum(
                torch.abs(ov - distribution.SORTED_OVERLAP),
                torch.abs(mono - distribution.SORTED_MONO),
            ),
            torch.minimum(
                torch.abs(ov - distribution.PSEUDO_OVERLAP),
                torch.abs(mono - distribution.PSEUDO_MONO),
            ),
        ),
        torch.abs(ov - distribution.WELL_SPREAD_OVERLAP),
    ).to(torch.float32)
    return BatchEstimates(
        ndv=comb.ndv,
        ndv_dict=ndv_dict,
        ndv_minmax=mm.ndv,
        layout=metrics.layout,
        is_lower_bound=comb.is_lower_bound,
        confidence=comb.confidence,
        overlap_ratio=metrics.overlap_ratio,
        monotonicity=metrics.monotonicity,
        mean_len=batch.mean_len,
        dict_iterations=dict_iters,
        route=comb.route,
        route_margin=comb.route_margin,
        detector_margin=detector_margin,
        dict_residual=dict_resid,
        coupon_iterations=mm.iterations,
        clamp_flags=comb.clamp_flags,
    )


def estimate_batch(
    batch: ColumnBatch,
    schema_bound: Optional[torch.Tensor] = None,
    *,
    mode: str = "paper",
    backend: str = "auto",
    fuse: str = "auto",
) -> BatchEstimates:
    """Vectorized zero-cost NDV estimation over a ColumnBatch.

    The per-batch program: the `repro_torch.engine` package is the public
    path onto it and owns chunking of the B axis and the device.

    Args:
      mode: "paper" — faithful reproduction (per-chunk max + Eq 13 hybrid);
            "improved" — beyond-paper layout-aware aggregation
            (coverage-corrected mean / disjoint-sum routing, see improved.py).
      backend: `repro_torch.kernels.ops` knob. "auto" = the kernel path (the
        CUDA kernels for CUDA tensors, their plain versions for CPU
        tensors); "cuda" = the kernel path, CUDA tensors only; "ref" = the
        reference numerics.
      fuse: "auto"/"off" run the per-stage path; "on" runs the whole §4-§7
        pipeline in one call of the reference numerics — and raises on a
        CUDA batch with a kernel backend, since the fused kernel is not
        ported yet (see `repro_torch.kernels.ops`).
    """
    from repro_torch.kernels import ops  # local: kernels.ref imports this module

    if ops.use_fused(fuse):
        return ops.fused_estimate(batch, schema_bound, mode=mode, backend=backend)
    return estimate_batch_core(batch, schema_bound, mode=mode, backend=backend)


def estimates_from_batch(
    out: BatchEstimates, batch: ColumnBatch, names: Sequence[str],
    *, offset: int = 0
) -> List[NDVEstimate]:
    """Materialize per-column NDVEstimate objects from batched output.

    `names` may be shorter than the batch axis: the packer pads B up to a
    shape bucket, and the padding lanes carry no column. `offset` selects
    where on the B axis the named lanes start.

    Each field is copied to the host once (one device-to-host copy per
    field, not one per column) and indexed as numpy from there.
    """
    host = {f: _host(getattr(out, f)) for f in out._fields}
    len_sample = _host(batch.len_sample)
    res: List[NDVEstimate] = []
    for j, name in enumerate(names):
        i = offset + j
        res.append(
            NDVEstimate(
                ndv=float(host["ndv"][i]),
                ndv_dict=float(host["ndv_dict"][i]),
                ndv_minmax=float(host["ndv_minmax"][i]),
                layout=Layout(int(host["layout"][i])),
                is_lower_bound=bool(host["is_lower_bound"][i]),
                mean_len=float(host["mean_len"][i]),
                len_sample_size=int(len_sample[i]),
                overlap_ratio=float(host["overlap_ratio"][i]),
                monotonicity=float(host["monotonicity"][i]),
                confidence=float(host["confidence"][i]),
                column_name=name,
            )
        )
    return res


ROUTE_NAMES = {
    int(combine_mod.ROUTE_MINMAX): "minmax",
    int(combine_mod.ROUTE_DICT): "dict",
}

_CLAMP_NAMES = (
    (combine_mod.CLAMP_NON_NULL, "non_null"),
    (combine_mod.CLAMP_INT_RANGE, "int_range"),
    (combine_mod.CLAMP_SINGLE_BYTE, "single_byte"),
    (combine_mod.CLAMP_SCHEMA, "schema_bound"),
)


def clamp_names(flags: int) -> List[str]:
    """Human-readable names of the CLAMP_* bits set in ``flags``."""
    return [name for bit, name in _CLAMP_NAMES if flags & bit]


@dataclasses.dataclass(frozen=True)
class Provenance:
    """How one column's estimate was produced (per-lane diagnostics).

    Deliberately a SEPARATE record from `NDVEstimate`: estimate identity
    (bodies, ETags, caches, spills) is derived by iterating NDVEstimate's
    fields, so diagnostics must live outside it to stay bit-neutral.
    Attached to responses only on explicit `?explain=1` request.
    """

    column_name: str
    route: str              # "dict" (§4 won Eq 13's max) or "minmax" (§5)
    route_margin: float     # [0, 1): 0 = the two signals tied
    detector_margin: float  # distance to the nearest §6 threshold
    overlap_ratio: float
    monotonicity: float
    layout: str
    dict_iterations: int    # §4 Newton iterations (max over chunks)
    dict_residual: float    # worst |Eq 2 residual| / S at the roots
    coupon_iterations: int  # §5 Newton iterations, winning side
    clamp_flags: int        # raw combine.CLAMP_* bitmask
    clamps: tuple           # decoded clamp names, e.g. ("schema_bound",)
    schema_bound_hit: bool
    is_lower_bound: bool
    confidence: float


def provenance_from_batch(
    out: BatchEstimates, batch: ColumnBatch, names: Sequence[str],
    *, offset: int = 0
) -> List[Provenance]:
    """Materialize per-column Provenance from batched output.

    Mirrors `estimates_from_batch` (one device-to-host copy per field,
    `offset` selects the lane span of a super-packed batch). Reads ONLY
    `out` — callers that cached the BatchEstimates can materialize
    provenance later without re-running the engine.
    """
    host = {
        f: _host(getattr(out, f))
        for f in (
            "route", "route_margin", "detector_margin", "dict_iterations",
            "dict_residual", "coupon_iterations", "clamp_flags", "layout",
            "overlap_ratio", "monotonicity", "is_lower_bound", "confidence",
        )
    }
    res: List[Provenance] = []
    for j, name in enumerate(names):
        i = offset + j
        flags = int(host["clamp_flags"][i])
        res.append(
            Provenance(
                column_name=name,
                route=ROUTE_NAMES[int(host["route"][i])],
                route_margin=float(host["route_margin"][i]),
                detector_margin=float(host["detector_margin"][i]),
                overlap_ratio=float(host["overlap_ratio"][i]),
                monotonicity=float(host["monotonicity"][i]),
                layout=Layout(int(host["layout"][i])).name,
                dict_iterations=int(host["dict_iterations"][i]),
                dict_residual=float(host["dict_residual"][i]),
                coupon_iterations=int(host["coupon_iterations"][i]),
                clamp_flags=flags,
                clamps=tuple(clamp_names(flags)),
                schema_bound_hit=bool(flags & combine_mod.CLAMP_SCHEMA),
                is_lower_bound=bool(host["is_lower_bound"][i]),
                confidence=float(host["confidence"][i]),
            )
        )
    return res


def record_provenance_metrics(provs: Sequence[Provenance]) -> None:
    """Observe freshly-computed provenance into the metrics registry.

    Called once per engine run at materialization time (never on cache
    hits), so the `ndv_route_total` / `ndv_newton_iters` /
    `ndv_detector_margin` series count estimator work, not request traffic.
    """
    from repro_torch.obs import metrics as obs_metrics

    reg = obs_metrics.registry()
    route_total = reg.counter(
        "ndv_route_total", "estimates produced per winning estimator route"
    )
    newton = reg.histogram(
        "ndv_newton_iters",
        "Newton iterations per estimate, by solver",
        buckets=obs_metrics.ITER_BUCKETS,
    )
    margin = reg.histogram(
        "ndv_detector_margin",
        "distance of detector metrics to the nearest layout threshold",
        buckets=obs_metrics.MARGIN_BUCKETS,
    )
    for p in provs:
        route_total.inc(route=p.route)
        newton.observe(p.dict_iterations, solver="dict")
        newton.observe(p.coupon_iterations, solver="coupon")
        margin.observe(p.detector_margin)
