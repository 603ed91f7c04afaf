"""Nested activities and parameter trees, flattened in ``jax.tree_util``'s
order.

The JAX package passes any pytree as a module's input or output (an
array, a :class:`~bigdl_tpu_torch.utils.table.Table`, a tuple, a list, a
dict) and flattens parameter trees with ``ravel_pytree``.  These helpers
walk the same containers in the same order, so a flattened parameter
vector and a list of leaves line up with the reference's:

- ``dict``: keys sorted;
- ``Table``: integer keys ascending, then the other keys by name;
- ``list`` and ``tuple``: in order;
- ``None``: a node without leaves.

Everything else (a tensor, a numpy array, a scalar, a ``QTensor``) is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from bigdl_tpu_torch.utils.table import Table


def _table_keys(t: Table) -> list:
    return sorted(t.keys(), key=lambda k: (0, k) if isinstance(k, int)
                  else (1, str(k)))


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; :func:`tree_unflatten` inverts it."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        kind = ("dict", keys)
        children = [tree[k] for k in keys]
    elif isinstance(tree, Table):
        keys = _table_keys(tree)
        kind = ("table", keys)
        children = [tree[k] for k in keys]
    elif isinstance(tree, (list, tuple)):
        kind = (type(tree), len(tree))
        children = list(tree)
    else:
        return [tree], "*"
    leaves, defs = [], []
    for c in children:
        sub, d = tree_flatten(c)
        leaves.extend(sub)
        defs.append((d, len(sub)))
    return leaves, (kind, defs)


def tree_unflatten(treedef, leaves):
    leaves = list(leaves)
    if treedef is None:
        return None
    if treedef == "*":
        return leaves[0]
    kind, defs = treedef
    children, i = [], 0
    for d, n in defs:
        children.append(tree_unflatten(d, leaves[i:i + n]))
        i += n
    if kind[0] == "dict":
        return dict(zip(kind[1], children))
    if kind[0] == "table":
        t = Table()
        for k, v in zip(kind[1], children):
            t[k] = v
        return t
    return kind[0](children)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
