"""The nested dict / list trees the port keeps params, states, labels,
gradients and optimizer moments in (the JAX package's pytrees, without
jax)."""

from typing import Any, List, Tuple


def tree_leaves_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict / list tree, in insertion order
    (None skipped); a path joins the keys and indices as "/a/0/b"."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in tree_leaves_with_path(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves_with_path(v, f"{path}/{i}")]
    return [] if tree is None else [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict / list tree, in insertion order (None skipped)."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of tree and the matching leaves of rest (tuples
    come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """fn(path, leaf, *matching leaves of rest) over the leaves of tree, with
    tree_leaves_with_path's paths (tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), path=f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree, *rest)
