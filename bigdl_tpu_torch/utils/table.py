"""Torch-style Table: a heterogeneous int/str-keyed map (port of
``bigdl_tpu/utils/table.py``).

The reference's ``utils/Table.scala:34-316`` (the ``T(...)`` builder):
multi-input/multi-output activities and name->tensor parameter tables.
The JAX package registers it as a pytree; here
:mod:`bigdl_tpu_torch.utils.pytree` knows it as a container node, with
the same leaf order (integer keys first, ascending, then the rest by
name).

Integer keys are 1-based, matching Torch/BigDL semantics.
"""
from __future__ import annotations

from typing import Any, Iterator



class Table:
    """Heterogeneous map with 1-based integer append semantics."""

    def __init__(self, *args: Any, **kwargs: Any):
        self._state: dict[Any, Any] = {}
        for v in args:
            self.insert(v)
        for k, v in kwargs.items():
            self._state[k] = v

    # -- dict-ish interface ------------------------------------------------
    def __getitem__(self, key: Any) -> Any:
        return self._state[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self._state[key] = value

    def __delitem__(self, key: Any) -> None:
        del self._state[key]

    def __contains__(self, key: Any) -> bool:
        return key in self._state

    def get(self, key: Any, default: Any = None) -> Any:
        return self._state.get(key, default)

    def get_or_update(self, key: Any, default: Any) -> Any:
        if key not in self._state:
            self._state[key] = default
        return self._state[key]

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def __len__(self) -> int:
        return len(self._state)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._state)

    # -- Torch array-part semantics ---------------------------------------
    def length(self) -> int:
        """Length of the contiguous 1-based integer 'array part'."""
        n = 0
        while (n + 1) in self._state:
            n += 1
        return n

    def insert(self, *args: Any) -> "Table":
        """insert(value) appends at length+1; insert(index, value) inserts,
        shifting the array part right (Torch ``table.insert`` semantics)."""
        if len(args) == 1:
            self._state[self.length() + 1] = args[0]
        else:
            index, value = args
            i = self.length()
            while i >= index:
                self._state[i + 1] = self._state[i]
                i -= 1
            self._state[index] = value
        return self

    def remove(self, index: int | None = None) -> Any:
        n = self.length()
        if index is None:
            index = n
        if n == 0:
            return None
        value = self._state.get(index)
        for i in range(index, n):
            self._state[i] = self._state[i + 1]
        if n in self._state:
            del self._state[n]
        return value

    def to_seq(self) -> list[Any]:
        return [self._state[i + 1] for i in range(self.length())]

    # -- misc --------------------------------------------------------------
    def clone(self) -> "Table":
        t = Table()
        t._state = dict(self._state)
        return t

    def update(self, other) -> "Table":
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self._state[k] = v
        return self

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Table):
            return self._state == other._state
        if isinstance(other, dict):
            return self._state == other
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self._state.items())
        return f"T({{{inner}}})"


def T(*args: Any, **kwargs: Any) -> Table:
    """Builder mirroring the reference's ``T(...)`` (utils/Table.scala)."""
    return Table(*args, **kwargs)
