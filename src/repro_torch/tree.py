"""Nested parameter trees: dicts, lists and tuples, and NamedTuples such as
``optim.OptState``, with tensors (or arrays) at the leaves.

The counterpart of the ``jax.tree_util`` calls the reference makes on its
pytrees.  Dict keys are visited in sorted order and a path is spelled by
``keystr`` as ``jax.tree_util.keystr`` spells it (``['blocks']['runs'][0]``
for dict keys and list indices, ``.mu`` for a NamedTuple field), so the
two packages name every leaf alike.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

# a path entry: ("key", dict key), ("idx", list index) or ("attr", field)
PathEntry = Tuple[str, object]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree) -> List[Tuple[tuple, object]]:
    """[(path, leaf)] in the reference's order."""
    out: list = []
    _flatten(tree, (), out)
    return out


# The walks are module functions, not closures that call themselves: such
# a closure is a reference cycle (the function holds the cell that holds
# it), and whatever it captured (the leaves, ``fn`` and what ``fn``
# captured) would then outlive the call until Python's cycle collector
# ran, holding a training step's old parameters, gradients and moments
# on the card.
def _flatten(node, path: tuple, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], path + (("key", k),), out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _flatten(getattr(node, name), path + (("attr", name),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, path + (("idx", i),), out)
    else:
        out.append((path, node))


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of the same path."""
    parts = []
    for kind, value in path:
        parts.append(f".{value}" if kind == "attr" else
                     f"[{value!r}]" if kind == "key" else f"[{value}]")
    return "".join(parts)


def map_with_path(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure whose leaf at each path is
    ``fn(path, leaf, *leaves of rest at that path)``."""
    return _map(fn, tree, list(rest), ())


def _map(fn: Callable, node, others: list, path: tuple):
    if isinstance(node, dict):
        return {k: _map(fn, node[k], [o[k] for o in others],
                        path + (("key", k),)) for k in node}
    if _is_namedtuple(node):
        return type(node)(*(
            _map(fn, getattr(node, name), [getattr(o, name) for o in others],
                 path + (("attr", name),)) for name in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v, [o[i] for o in others],
                               path + (("idx", i),))
                          for i, v in enumerate(node))
    return fn(path, node, *others)


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` applied leaf by leaf."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten_like(tree, new_leaves) -> object:
    """``tree``'s structure with ``new_leaves`` (in ``flatten_with_path``
    order) at its leaves."""
    order = {path: i for i, (path, _) in enumerate(flatten_with_path(tree))}
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(order):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(order)}")
    return map_with_path(lambda path, _: new_leaves[order[path]], tree)
