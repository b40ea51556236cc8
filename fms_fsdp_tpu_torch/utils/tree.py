"""Walk nested dicts and lists of tensors: the shape of every params tree
and decode state of the port (what ``jax.tree.map`` does for the JAX
package)."""


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists and tuples;
    tuples come back as lists), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
