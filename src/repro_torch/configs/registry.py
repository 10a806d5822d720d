"""Architecture registry: name → (arch, shapes), for the archs the port has."""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ArchBundle", "register", "get_arch", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch: Any
    shapes: dict[str, Any]  # shape-name -> shape spec

    @property
    def family(self) -> str:
        return self.arch.family


_REGISTRY: dict[str, ArchBundle] = {}


def register(arch, shapes) -> None:
    _REGISTRY[arch.name] = ArchBundle(arch=arch, shapes={s.name: s for s in shapes})


def get_arch(name: str) -> ArchBundle:
    import repro_torch.configs  # noqa: F401 — populate registry

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
