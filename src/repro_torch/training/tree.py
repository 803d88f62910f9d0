"""Parameter and optimizer-state trees in the JAX package's order.

The port's counterpart of the ``jax.tree_util`` calls the reference's
training code makes: a tree is nested dicts (children in sorted key
order, as JAX flattens them), lists and tuples (in order) and
NamedTuples (by field), with ``None`` an empty subtree; anything else
is a leaf.  :func:`flatten` gives each leaf with the path string the
reference's checkpoints store (``jax.tree_util.tree_flatten_with_path``
joined by ``/``: ``['blocks']/['segments']/[0]/['attn']/['wq']``,
``.mu/['embed']/['w']``), so the two packages' checkpoints name their
leaves alike and the optimizer sums the gradient norm in the same
order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"['{k}']", tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{k}", getattr(tree, k)) for k in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, child in items:
        out += flatten(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in
    :func:`flatten`'s order."""
    it = iter(new_leaves)

    def build(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            built = {k: build(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        if _is_namedtuple(tree):
            return type(tree)(*[build(getattr(tree, k))
                                for k in tree._fields])
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
