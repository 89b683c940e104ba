"""PETSc-style options database.

The reference configures every object through the PETSc options
database with per-object prefixes (e.g. ``-cart_grid_x 64``,
``-ns_density 1.0``, ``-ns_abf_schur_ksp_rtol 1e-8``; see
fluca/src/mesh/impl/cart/cart.c:13-54 and
fluca/src/ns/interface/nsopts.c:167-203). This module reproduces that
discipline: a flat string->string map, prefix-scoped views, and typed
getters. Options may come from CLI argv, a dict, or JSON.
"""

from __future__ import annotations

import json


class Options:
    def __init__(self, table: dict | None = None, prefix: str = ""):
        self._table = dict(table or {})
        self._prefix = prefix

    # -- construction -------------------------------------------------
    @classmethod
    def from_argv(cls, argv) -> "Options":
        """Parse ``-name value`` / ``-flag`` pairs like PetscInitialize."""
        table = {}
        i = 0
        argv = list(argv)
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("-") and not _is_number(tok):
                name = tok.lstrip("-")
                if i + 1 < len(argv) and (
                    not argv[i + 1].startswith("-") or _is_number(argv[i + 1])
                ):
                    table[name] = argv[i + 1]
                    i += 2
                else:
                    table[name] = ""  # boolean flag
                    i += 1
            else:
                i += 1
        return cls(table)

    @classmethod
    def from_json(cls, path) -> "Options":
        with open(path) as f:
            return cls({k: str(v) for k, v in json.load(f).items()})

    def sub(self, prefix: str) -> "Options":
        """Scoped view sharing the same table: lookups/sets of ``name``
        resolve ``<prefix>name``."""
        view = Options.__new__(Options)
        view._table = self._table
        view._prefix = self._prefix + prefix
        return view

    def set(self, name: str, value) -> None:
        self._table[self._prefix + name] = str(value)

    # -- typed getters ------------------------------------------------
    def _raw(self, name):
        return self._table.get(self._prefix + name)

    def has(self, name: str) -> bool:
        return self._prefix + name in self._table

    def get_str(self, name: str, default: str | None = None):
        v = self._raw(name)
        return default if v is None else v

    def get_int(self, name: str, default: int | None = None):
        v = self._raw(name)
        return default if v is None else int(v)

    def get_real(self, name: str, default: float | None = None):
        v = self._raw(name)
        return default if v is None else float(v)

    def get_bool(self, name: str, default: bool = False):
        v = self._raw(name)
        if v is None:
            return default
        return v.lower() not in ("0", "false", "no", "off")

    def items(self):
        return self._table.items()

    def __repr__(self):
        return f"Options(prefix={self._prefix!r}, {self._table!r})"


_global = Options()


def global_options() -> Options:
    return _global


def set_global_options(opts: Options) -> None:
    global _global
    _global = opts


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False
