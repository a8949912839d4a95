"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled on first use with `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, and loaded with
`ctypes`. The build needs only the repository's sources and the CUDA toolkit:
no PyTorch headers, so a file builds in seconds. Libraries land in the
repository's `build/` directory (git-ignored), named by a hash of the source
and the flags, so a changed source is rebuilt and an unchanged one is reused.

Flags: no fast math, and `-fmad=false`, so each kernel rounds every
operation as its plain PyTorch version's separate elementwise ops do (see
the notes in the sources).

Launch counts: every wrapper that launches a kernel adds one to its entry in
`LAUNCHES` right there, and nowhere else, so a run can show that its main
path went through the kernels (`reset_launch_counts` / `launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("newton_ndv.cu", "minmax_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# C entry points per library: name -> argtypes. Every pointer and the stream
# are c_void_p (a plain int would be cut to 32 bits); each returns the
# cudaGetLastError() code as an int.
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "newton_ndv.cu": {
        "dict_newton_launch": [_P, _P, _P, _P, _P, _I64, _I, _P],
        "coupon_newton_launch": [_P, _P, _P, _I64, _I, _P],
    },
    "minmax_scan.cu": {
        "minmax_scan_launch": [_P, _P, _P, _P, _I64, _I64, _I, _P],
    },
}

LAUNCHES: Dict[str, int] = {"dict_newton": 0, "coupon_newton": 0, "minmax_scan": 0}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    """`<repo>/build`, next to `src/` (listed in .gitignore)."""
    return CSRC.parents[3] / "build"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(*, ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every source not yet built, one `nvcc` per source, in parallel.

    Returns {source: {"seconds": wall seconds, "log": compiler output}} for
    the sources compiled by this call. Raises RuntimeError naming the source
    whose compilation failed, with the compiler's output.
    """
    with _LOCK:
        return _build_locked(ptxas_verbose)


def _build_locked(ptxas_verbose: bool) -> Dict[str, dict]:
    build_dir().mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    result, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        result[src] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def library(source: str) -> ctypes.CDLL:
    """The loaded library for `source`, building every source first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        path = _lib_path(source)
        if not path.exists():
            _build_locked(False)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
        return lib


def on_cuda(name: str, tensors: List) -> bool:
    """A wrapper's route: True (launch the kernel) when every input is a CUDA
    tensor, False (run the plain version) when every input is on the CPU.
    Anything else raises: the plain version never stands in for the card."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"{name}: inputs on {sorted(types)}; need all CPU or all CUDA")


def check_cuda_inputs(name: str, tensors: List, dtypes: List) -> int:
    """Validate kernel inputs; return their common CUDA device index.

    Every tensor must lie on one CUDA device, be contiguous and have the
    dtype the kernel reads. A kernel takes raw pointers, so anything else
    would be read as garbage: raise instead.
    """
    dev = tensors[0].device
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{name}: input {i} is on {t.device}, expected one CUDA device"
            )
        if t.dtype != dt:
            raise TypeError(f"{name}: input {i} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} is not contiguous")
    return dev.index if dev.index is not None else 0


def raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_handle(device_index: int) -> Optional[int]:
    import torch

    return torch.cuda.current_stream(device_index).cuda_stream
