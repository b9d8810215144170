"""Lazy package re-exports (PEP 562): a package's ``__getattr__`` that
imports the module holding a re-exported name on its first access, so that
importing the package imports none of them."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Sequence


def lazy_getattr(package: str, table: Dict[str, Sequence[str]]) -> Callable:
    """``__getattr__`` for ``package`` from ``{module: (name, ...)}``."""
    where = {name: module for module, names in table.items() for name in names}

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(where[name]), name)

    return __getattr__
