"""Public entry points of the fused level kernels K1 and K2.

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
from .dependency_spmm import dependency_spmm_cuda
from .frontier_spmm import frontier_spmm_cuda

__all__ = ["frontier_spmm", "dependency_spmm", "LAUNCHES", "reset_launches"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"frontier_spmm": 0, "dependency_spmm": 0}

ADJACENCY_DTYPES = (torch.float32, torch.bfloat16)
# the kernels index rows with a 16-bit-limited grid dimension of 128-row tiles
MAX_N = 65535 * 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name: str, adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor,
           delta: torch.Tensor | None = None, omega: torch.Tensor | None = None) -> None:
    if adjacency.dtype not in ADJACENCY_DTYPES:
        raise TypeError(f"{name}: adjacency must be float32 or bfloat16, got {adjacency.dtype}")
    if adjacency.dim() != 2 or adjacency.shape[0] != adjacency.shape[1]:
        raise ValueError(f"{name}: adjacency must be square [n, n], got {tuple(adjacency.shape)}")
    n = adjacency.shape[0]
    if n > MAX_N:
        raise ValueError(f"{name}: n = {n} exceeds the kernel's limit of {MAX_N}")
    operands = {"sigma": (sigma, torch.float32), "depth": (depth, torch.int32)}
    if delta is not None:
        operands["delta"] = (delta, torch.float32)
    for key, (t, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != n or t.shape != sigma.shape:
            raise ValueError(
                f"{name}: {key} must be [n={n}, s] like sigma, got {tuple(t.shape)}"
            )
    if omega is not None:
        if omega.dtype != torch.float32:
            raise TypeError(f"{name}: omega must be float32, got {omega.dtype}")
        if tuple(omega.shape) != (n,):
            raise ValueError(f"{name}: omega must be [n={n}], got {tuple(omega.shape)}")
        operands["omega"] = (omega, torch.float32)
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
