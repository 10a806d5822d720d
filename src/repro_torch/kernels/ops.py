"""Public entry points of the level kernels K1–K4.

K1/K2 (:func:`frontier_spmm`, :func:`dependency_spmm`) are the fused
single-device level steps on a square adjacency; K3/K4
(:func:`frontier_spmm_partial`, :func:`dependency_spmm_partial`) are their
pre-fold partials on one device's rectangular block of the 2-D
decomposition, with an optional ``acc`` running sum (the ring schedule's
combine).

Each wrapper checks its operands (device, dtype, shape, contiguity) and
raises on anything the kernel does not take.  Then:

* tensors on the CPU go to the plain PyTorch version (kernels/ref.py);
* tensors on a CUDA device go to the hand-written kernel, which either
  launches or raises — there is no fallback.

:data:`LAUNCHES` counts kernel launches per wrapper (plain ints, bumped
only where a kernel was launched), so a run can show that its main path
went through the kernels; :func:`reset_launches` zeroes them.
"""
from __future__ import annotations

import torch

from . import ref
from .dependency_spmm import dependency_partial_cuda, dependency_spmm_cuda
from .frontier_spmm import frontier_partial_cuda, frontier_spmm_cuda

__all__ = [
    "frontier_spmm",
    "dependency_spmm",
    "frontier_spmm_partial",
    "dependency_spmm_partial",
    "LAUNCHES",
    "reset_launches",
]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {
    "frontier_spmm": 0,
    "dependency_spmm": 0,
    "frontier_spmm_partial": 0,
    "dependency_spmm_partial": 0,
}

ADJACENCY_DTYPES = (torch.float32, torch.bfloat16)
# the kernels index rows with a 16-bit-limited grid dimension of 128-row tiles
MAX_N = 65535 * 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name: str, adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor,
           delta: torch.Tensor | None = None, omega: torch.Tensor | None = None,
           acc: torch.Tensor | None = None, *, square: bool = True) -> None:
    """Validate a level kernel's operands: adjacency [m, k] (square for
    K1/K2), (σ, d[, δ]) [k, s], ω [k], acc f32 [m, s]."""
    if adjacency.dtype not in ADJACENCY_DTYPES:
        raise TypeError(f"{name}: adjacency must be float32 or bfloat16, got {adjacency.dtype}")
    if adjacency.dim() != 2:
        raise ValueError(f"{name}: adjacency must be 2-D, got {tuple(adjacency.shape)}")
    m, k = adjacency.shape
    if square and m != k:
        raise ValueError(f"{name}: adjacency must be square [n, n], got {tuple(adjacency.shape)}")
    if m > MAX_N:
        raise ValueError(f"{name}: {m} adjacency rows exceed the kernel's limit of {MAX_N}")
    operands = {"sigma": (sigma, torch.float32), "depth": (depth, torch.int32)}
    if delta is not None:
        operands["delta"] = (delta, torch.float32)
    for key, (t, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != k or t.shape != sigma.shape:
            raise ValueError(
                f"{name}: {key} must be [{k}, s] like sigma, got {tuple(t.shape)}"
            )
    if omega is not None:
        if omega.dtype != torch.float32:
            raise TypeError(f"{name}: omega must be float32, got {omega.dtype}")
        if tuple(omega.shape) != (k,):
            raise ValueError(f"{name}: omega must be [{k}], got {tuple(omega.shape)}")
        operands["omega"] = (omega, torch.float32)
    if acc is not None:
        if acc.dtype != torch.float32:
            raise TypeError(f"{name}: acc must be float32, got {acc.dtype}")
        if tuple(acc.shape) != (m, sigma.shape[1]):
            raise ValueError(f"{name}: acc must be [{m}, s], got {tuple(acc.shape)}")
        operands["acc"] = (acc, torch.float32)
    tensors = [adjacency] + [t for t, _ in operands.values()]
    if any(t.device != adjacency.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if adjacency.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {adjacency.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def frontier_spmm(
    adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor, lvl: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused forward BFS level (K1): returns (σ', d').  See
    kernels/ref.py:frontier_spmm_ref for the semantics."""
    _check("frontier_spmm", adjacency, sigma, depth)
    if adjacency.device.type == "cpu":
        return ref.frontier_spmm_ref(adjacency, sigma, depth, lvl)
    if sigma.numel() == 0:
        return sigma.clone(), depth.clone()
    out = frontier_spmm_cuda(adjacency, sigma, depth, lvl)
    LAUNCHES["frontier_spmm"] += 1
    return out


def dependency_spmm(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
) -> torch.Tensor:
    """Fused backward dependency level (K2): returns δ'.  See
    kernels/ref.py:dependency_spmm_ref for the semantics."""
    _check("dependency_spmm", adjacency, sigma, depth, delta, omega)
    if adjacency.device.type == "cpu":
        return ref.dependency_spmm_ref(adjacency, sigma, depth, delta, omega, lvl)
    if sigma.numel() == 0:
        return delta.clone()
    out = dependency_spmm_cuda(adjacency, sigma, depth, delta, omega, lvl)
    LAUNCHES["dependency_spmm"] += 1
    return out


def _empty_partial(adjacency: torch.Tensor, sigma: torch.Tensor, acc: torch.Tensor | None):
    """The result of a partial with no output elements (m = 0 or s = 0)."""
    if acc is not None:
        return acc.clone()
    return torch.zeros((adjacency.shape[0], sigma.shape[1]), device=sigma.device)


def frontier_spmm_partial(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold forward partial on a rectangular block (K3): returns t f32
    [m, s].  See kernels/ref.py:frontier_partial_ref for the semantics."""
    _check("frontier_spmm_partial", adjacency, sigma, depth, acc=acc, square=False)
    if adjacency.device.type == "cpu":
        return ref.frontier_partial_ref(adjacency, sigma, depth, lvl, acc)
    if adjacency.shape[0] == 0 or sigma.shape[1] == 0:
        return _empty_partial(adjacency, sigma, acc)
    out = frontier_partial_cuda(adjacency, sigma, depth, lvl, acc)
    LAUNCHES["frontier_spmm_partial"] += 1
    return out


def dependency_spmm_partial(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold backward partial on a rectangular block (K4): returns t f32
    [m, s].  See kernels/ref.py:dependency_partial_ref for the semantics."""
    _check("dependency_spmm_partial", adjacency, sigma, depth, delta, omega, acc, square=False)
    if adjacency.device.type == "cpu":
        return ref.dependency_partial_ref(adjacency, sigma, depth, delta, omega, lvl, acc)
    if adjacency.shape[0] == 0 or sigma.shape[1] == 0:
        return _empty_partial(adjacency, sigma, acc)
    out = dependency_partial_cuda(adjacency, sigma, depth, delta, omega, lvl, acc)
    LAUNCHES["dependency_spmm_partial"] += 1
    return out
