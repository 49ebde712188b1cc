"""Mesh, collectives, ring schedules and sequence-parallel attention.

The attention builders re-export lazily (PEP 562): importing the package
imports no kernel module and builds nothing.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "build_ring_attention": ".attention",
    "build_ulysses_attention": ".attention",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value
