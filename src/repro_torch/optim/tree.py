"""Parameter trees of the optimiser: dicts, lists and tuples of tensors,
the layout the reference's pytrees have.  Dicts flatten in sorted key
order, as ``jax.tree`` flattens them, so a global sum runs over the
leaves in the reference's order."""

from __future__ import annotations


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten(tree) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def flatten_up_to(structure, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``structure``
    (``treedef.flatten_up_to``): a per-leaf state dict stays whole."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure)
                for x in flatten_up_to(structure[k], tree[k])]
    if isinstance(structure, (list, tuple)):
        return [x for s, t in zip(structure, tree)
                for x in flatten_up_to(s, t)]
    return [tree]


def unflatten(structure, leaves) -> object:
    """``structure``'s containers holding ``leaves`` in flatten order."""
    return _build(structure, iter(leaves))


def _build(s, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``leaves`` (a step's gradients) until the next
    # garbage collection
    if isinstance(s, dict):
        built = {k: _build(s[k], it) for k in sorted(s)}
        return {k: built[k] for k in s}
    if isinstance(s, (list, tuple)):
        return type(s)(_build(v, it) for v in s)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s containers."""
    flat = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(flatten(tree), *flat)])
