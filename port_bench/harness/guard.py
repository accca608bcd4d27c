"""Which modules may be loaded, by whole top-level name.

The port's package name begins with the JAX package's, so a prefix test
would confuse them: the top-level name (the part before the first dot) is
compared whole."""

from __future__ import annotations

import sys
from typing import Iterable, List, Mapping, Optional

JAX_NAMES = frozenset({"jax", "jaxlib", "flax",
                       "handwritten_math_ocr_api_tpu"})
PROGRAM_NAMES = frozenset({"handwritten_math_ocr_api_torch"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(forbidden: Iterable[str],
           modules: Optional[Mapping] = None) -> List[str]:
    """The loaded modules whose top-level name is one of ``forbidden``."""
    forbidden = frozenset(forbidden)
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if top_level(m) in forbidden)


def imported_by(module, forbidden: Iterable[str]) -> List[str]:
    """Names in ``module``'s namespace that are modules, or objects defined
    in modules, whose top-level name is one of ``forbidden``."""
    import types

    forbidden = frozenset(forbidden)
    bad = []
    for name, value in vars(module).items():
        mod = (value.__name__ if isinstance(value, types.ModuleType)
               else getattr(value, "__module__", None))
        if isinstance(mod, str) and top_level(mod) in forbidden:
            bad.append(name)
    return sorted(bad)
