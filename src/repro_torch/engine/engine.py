"""`EstimationEngine`: strategy-routed execution of `estimate_batch`.

See the package docstring for the seam design. The engine is stateless
apart from its config and device — all caching lives in `StatsCatalog`,
keyed by `engine.cache_key` so differently-computing engines never share
entries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.catalog.packer import BatchPacker
from repro_torch.core.ndv.estimator import (
    BatchEstimates,
    estimate_batch,
    estimates_from_batch,
)
from repro_torch.core.ndv.types import ColumnBatch, ColumnMetadata, NDVEstimate
from repro_torch.engine.config import DEFAULT_MAX_BATCH, EngineConfig
from repro_torch.obs import registry, span as _obs_span

# max_batch="auto" sizing. A packed lane (one column) costs ~22 bytes per
# (lane, row-group) cell across the seven (B, R) planes plus ~50 bytes of
# per-lane scalars; at the bucketed R ceilings real warehouses hit (<=256)
# that is ~6 KB, and the estimators' masked intermediates (several
# temporaries per plane across the Newton iterations) multiply it by a
# small constant. 64 KB/lane is that footprint with ~10x headroom — the
# budget only needs the right order of magnitude, since chunk width is
# numerics-neutral and merely bounds peak memory.
AUTO_MEM_FRACTION = 0.25
NOMINAL_LANE_BYTES = 1 << 16
AUTO_MIN_BATCH = 1024
AUTO_MAX_BATCH = 1 << 20

MULTI_DEVICE = ("sharded", "composed")

_DISPATCHES = registry().counter(
    "ndv_engine_dispatches_total",
    "Engine estimate() dispatches, by resolved strategy and mode",
)


def resolve_device(device) -> torch.device:
    """`EngineConfig.device` -> torch.device; RuntimeError for an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            'is false; pass EngineConfig(device="cpu") to compute on the CPU'
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def detect_device_memory(device: torch.device) -> Optional[int]:
    """Bytes of memory on `device` (total, from `torch.cuda.mem_get_info`),
    or None on the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def auto_chunk_budget(mem_bytes: Optional[int], shards: int = 1) -> int:
    """Device memory -> chunk budget: the largest power of two of nominal
    lanes fitting in `AUTO_MEM_FRACTION` of memory, clamped to
    [AUTO_MIN_BATCH, AUTO_MAX_BATCH]. None -> `DEFAULT_MAX_BATCH`.
    """
    if not mem_bytes:
        return DEFAULT_MAX_BATCH
    lanes = int(mem_bytes * AUTO_MEM_FRACTION / NOMINAL_LANE_BYTES / max(shards, 1))
    lanes = max(AUTO_MIN_BATCH, min(lanes, AUTO_MAX_BATCH))
    return 1 << (lanes.bit_length() - 1)  # previous power of two


def _pad_axis0(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the leading (B) axis up to `target` lanes.

    Zero is the packer's own padding value for every field — it yields
    `valid=False` / `n_groups=0` lanes that the estimator fully masks.
    """
    if x.shape[0] == target:
        return x
    pad = x.new_zeros((target - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)


class EstimationEngine:
    """Routes a packed `ColumnBatch` to an execution strategy on one device."""

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self._packer: Optional[BatchPacker] = None
        self._auto_budget: Optional[int] = None

    # -- identity ------------------------------------------------------------

    @property
    def cache_token(self) -> str:
        """Numerics identity as a compact stable string: the backend's
        numerics on this engine's device type ("t.cuda", "t.cpu",
        "t.ref.cuda", "t.ref.cpu").

        Never the JAX package's "k.*" tokens: the two packages may differ
        in the last ulp, so neither may validate the other's results; the
        same holds between the card and the CPU. Strategy, chunk budget and
        fuse are numerics-neutral and stay out.
        """
        from repro_torch.kernels import ops

        return ops.cache_token(self.config.backend, self.device.type)

    @property
    def cache_key(self) -> tuple:
        """Hashable numerics identity (catalog cache key component)."""
        return (self.cache_token,)

    def make_packer(self) -> BatchPacker:
        """The packer coordinated with this engine (one per engine)."""
        if self._packer is None:
            self._packer = BatchPacker()
        return self._packer

    # -- strategy resolution --------------------------------------------------

    def resolve_max_batch(self) -> int:
        """The chunk budget: a fixed config value, or "auto" from the card's
        memory, read once per engine (`DEFAULT_MAX_BATCH` on the CPU)."""
        mb = self.config.max_batch
        if mb != "auto":
            return mb
        if self._auto_budget is None:
            self._auto_budget = auto_chunk_budget(detect_device_memory(self.device))
        return self._auto_budget

    def resolve_strategy(self, batch_width: int) -> str:
        s = self.config.strategy
        if s in MULTI_DEVICE:
            raise NotImplementedError(
                f"strategy {s!r} (several CUDA devices) is not ported yet: "
                "ROADMAP Queue A item 11"
            )
        if s != "auto":
            return s
        return "chunked" if batch_width > self.resolve_max_batch() else "local"

    # -- execution -----------------------------------------------------------

    def _on_device(self, batch: ColumnBatch, schema_bound):
        if batch.device != self.device:
            batch = batch.to(self.device)
        if schema_bound is not None:
            schema_bound = torch.as_tensor(
                schema_bound, dtype=torch.float32
            ).to(self.device)
        return batch, schema_bound

    def estimate(
        self,
        batch: ColumnBatch,
        schema_bound: Optional[torch.Tensor] = None,
        *,
        mode: str = "paper",
    ) -> BatchEstimates:
        """ColumnBatch -> BatchEstimates under the configured strategy.

        The batch is moved to the engine's device if it is elsewhere (the
        catalog hands over batches that are already resident). For real
        (non-padding) lanes the output is bit-identical across strategies:
        padding lanes are fully masked and no estimator op mixes information
        across the B axis, so re-tiling B is exact.
        """
        strategy = self.resolve_strategy(batch.batch)
        batch, schema_bound = self._on_device(batch, schema_bound)
        _DISPATCHES.inc(strategy=strategy, mode=mode)
        with _obs_span(
            "engine.dispatch",
            strategy=strategy, mode=mode, batch=int(batch.batch),
        ):
            if strategy == "chunked":
                return self._estimate_chunked(batch, schema_bound, mode)
            return self._run(batch, schema_bound, mode)

    def _run(self, batch, schema_bound, mode) -> BatchEstimates:
        return estimate_batch(
            batch, schema_bound, mode=mode,
            backend=self.config.backend, fuse=self.config.fuse,
        )

    def _estimate_chunked(self, batch, schema_bound, mode) -> BatchEstimates:
        c = self.resolve_max_batch()
        b = batch.batch
        if b <= c:
            return self._run(batch, schema_bound, mode)
        target = -(-b // c) * c
        if target != b:
            batch = ColumnBatch(
                **{k: _pad_axis0(v, target) for k, v in batch.fields().items()}
            )
            if schema_bound is not None:
                # +inf = "no bound": combine() keeps the estimate unchanged.
                schema_bound = torch.cat([
                    schema_bound,
                    schema_bound.new_full((target - b,), float("inf")),
                ])
        parts: List[BatchEstimates] = []
        for lo in range(0, target, c):
            sb = None if schema_bound is None else schema_bound[lo:lo + c]
            parts.append(self._run(batch.slice(lo, lo + c), sb, mode))
        out = BatchEstimates(*[torch.cat(field) for field in zip(*parts)])
        if target == b:
            return out
        return BatchEstimates(*[field[:b] for field in out])

    # -- object API ----------------------------------------------------------

    def estimate_columns(
        self,
        cols: Sequence[ColumnMetadata],
        schema_bounds: Optional[Sequence[float]] = None,
        *,
        mode: str = "paper",
        packer: Optional[BatchPacker] = None,
    ) -> List[NDVEstimate]:
        """List of ColumnMetadata -> list of NDVEstimate via this engine."""
        if not cols:
            return []
        batch = (packer or self.make_packer()).pack(cols)
        sb = None
        if schema_bounds is not None:
            arr = np.full(batch.batch, np.inf, np.float32)
            arr[: len(cols)] = np.asarray(schema_bounds, np.float32)
            sb = torch.from_numpy(arr)
        out = self.estimate(batch, sb, mode=mode)
        return estimates_from_batch(out, batch, [c.column_name for c in cols])


@dataclasses.dataclass
class _Defaults:
    engine: Optional[EstimationEngine] = None


_DEFAULTS = _Defaults()


def default_engine() -> EstimationEngine:
    """Process-wide default engine: `EngineConfig()`, on the CUDA device.

    Raises RuntimeError where no card is visible, like every engine asked
    for "cuda".
    """
    if _DEFAULTS.engine is None:
        _DEFAULTS.engine = EstimationEngine(EngineConfig())
    return _DEFAULTS.engine


def default_packer() -> BatchPacker:
    """The default engine's shared packer."""
    return default_engine().make_packer()
