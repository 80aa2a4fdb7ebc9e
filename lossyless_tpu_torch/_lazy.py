"""Lazy package exports (PEP 562).

A package's `__init__` names what it exports and the submodule each name
lives in; the submodule is imported when the name is first read. Importing
a package so imports none of its submodules: `analysis.kaggle` does not
pull in pandas and matplotlib through `analysis.aggregate`, and
`compressors`, `nn` and `pipeline` cannot form an import cycle through
their `__init__` files.
"""

from __future__ import annotations

import importlib
import sys


def exports(package: str, where: dict[str, str]):
    """`(__all__, __getattr__, __dir__)` for `package`, which exports each
    name of `where` from the submodule it maps to (relative, `.name`). A
    name equal to its submodule's last component is the submodule."""

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(where[name], package)
        value = module if where[name] == f".{name}" \
            else getattr(module, name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(where))

    return list(where), __getattr__, __dir__
