"""String-keyed type registries.

The reference uses PetscFunctionList for runtime-extensible registries
of mesh types, NS types, FD types and TVD limiters (fluca/src/fd/
interface/fdreg.c:17-29, fluca/src/ns/interface/nsreg.c). This is the
same idea as a plain dict with a register/create API.
"""

from __future__ import annotations


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._table: dict[str, object] = {}

    def register(self, name: str, factory) -> None:
        self._table[name] = factory

    def create(self, name: str, *args, **kwargs):
        try:
            factory = self._table[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} type {name!r}; "
                f"registered: {sorted(self._table)}"
            ) from None
        return factory(*args, **kwargs)

    def get(self, name: str):
        try:
            return self._table[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} type {name!r}; "
                f"registered: {sorted(self._table)}"
            ) from None

    def names(self):
        return sorted(self._table)

    def __contains__(self, name):
        return name in self._table
