"""Parameter trees: nested dicts (and lists, tuples) of tensors.

The reference's pytrees flatten dict keys in sorted order; these helpers
keep that order, so the n-th leaf of a tree is the same parameter in both
packages, and every rank of a mesh walks its leaves (and issues their
collectives) in the same order.
"""
from __future__ import annotations


def flatten(tree):
    """Leaves of a tree of dicts (sorted keys, as JAX orders them), lists and
    tuples, and a function that rebuilds the tree from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [lf for p in parts for lf in p[0]]

    def rebuild(new):
        out, off = [], 0
        for (_, build), sz in zip(parts, sizes):
            out.append(build(new[off:off + sz]))
            off += sz
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    share its structure; the result has ``tree``'s structure."""
    ls, rebuild = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return rebuild([fn(*args) for args in zip(ls, *others)])
