"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Every ``csrc/*.cu`` is compiled to an object file by its own ``nvcc``
process (all started together), then linked into one shared library with
a plain C interface::

    build/repro_torch/<hash of sources and flags>/libbc_kernels.so

under the checkout's root.  A library whose hash matches is reused; a
missing ``nvcc`` or a failed compile raises — there is no fallback.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["find_nvcc", "build", "build_log", "library"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libbc_kernels.so"

# sm_90a: Hopper with its architecture-specific features.  No
# --use_fast_math: K2, K4 and K6 divide, and the reference divides in IEEE f32.
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (A, σ, d, σ_out, d_out, operand, n, s, ld, lvl, bs, fast, device, stream)
_FRONTIER_ARGS = [_P] * 6 + [_I] * 7 + [_P]
# (A, σ, d, δ, ω, δ_out, operand, n, s, ld, lvl, bs, fast, device, stream)
_DEPENDENCY_ARGS = [_P] * 7 + [_I] * 7 + [_P]
# (A, σ, d, t_in or NULL, t_out, operand, m, k, s, ld, lvl, bs, fast, device, stream)
_FRONTIER_PARTIAL_ARGS = [_P] * 6 + [_I] * 8 + [_P]
# (A, σ, d, δ, ω, t_in or NULL, t_out, operand, m, k, s, ld, lvl, bs, fast, device, stream)
_DEPENDENCY_PARTIAL_ARGS = [_P] * 8 + [_I] * 8 + [_P]
# (col, val, seg, long_ptr, σ, d, t_in or NULL, t_out, operand, partials,
#  m, k, s, n_seg, n_long_rows, lvl, device, stream)
_FRONTIER_SPARSE_ARGS = [_P] * 10 + [_I] * 7 + [_P]
# (col, val, seg, long_ptr, σ, d, δ, ω, t_in or NULL, t_out, operand, partials,
#  m, k, s, n_seg, n_long_rows, lvl, device, stream)
_DEPENDENCY_SPARSE_ARGS = [_P] * 12 + [_I] * 7 + [_P]
# (table, idx, weights or NULL, out, num_bags, L, D, device, stream)
_SEGMENT_BAG_ARGS = [_P, _P, _P, _P, _L, _I, _I, _I, _P]
# (x, src, seg, long_ptr, out, partials, kdim, s, n_seg, n_long_seg, n_long_rows,
#  device, stream)
_ARC_PRODUCT_ARGS = [_P] * 6 + [_I] * 6 + [_P]
SIGNATURES = {
    "frontier_spmm_f32": _FRONTIER_ARGS,
    "frontier_spmm_bf16": _FRONTIER_ARGS,
    "dependency_spmm_f32": _DEPENDENCY_ARGS,
    "dependency_spmm_bf16": _DEPENDENCY_ARGS,
    "frontier_partial_f32": _FRONTIER_PARTIAL_ARGS,
    "frontier_partial_bf16": _FRONTIER_PARTIAL_ARGS,
    "dependency_partial_f32": _DEPENDENCY_PARTIAL_ARGS,
    "dependency_partial_bf16": _DEPENDENCY_PARTIAL_ARGS,
    "frontier_sparse_f32": _FRONTIER_SPARSE_ARGS,
    "dependency_sparse_f32": _DEPENDENCY_SPARSE_ARGS,
    "segment_bag_f32": _SEGMENT_BAG_ARGS,
    "segment_bag_bf16": _SEGMENT_BAG_ARGS,
    "arc_product_f32": _ARC_PRODUCT_ARGS,
    "level_gemm_shared_bytes": [_I, _I],  # (bs, bf16)
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit that PyTorch's own extension builder finds; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "port's kernels"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (once per source
    hash) and return its path.  The ptxas report (registers, shared
    memory, spills) is kept beside it; see :func:`build_log`."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        cus = sorted(CSRC.glob("*.cu"))
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(cu),
                 "-o", str(tmp / f"{cu.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for cu in cus
        ]
        logs = [p.communicate()[0] for p in procs]  # waits for every process
        for cu, p, log in zip(cus, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu.name}:\n{log}")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{cu.stem}.o") for cu in cus)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text(
            "".join(f"== {cu.name}\n{log}" for cu, log in zip(cus, logs))
        )
        try:
            tmp.rename(out_dir)
        except OSError:  # another process finished the same build first
            if not lib_path.is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """The ptxas report of the current build (empty before a build)."""
    log = BUILD_ROOT / _source_hash() / "build.log"
    return log.read_text() if log.is_file() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with ``argtypes``
    and ``restype`` set on every launcher."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
