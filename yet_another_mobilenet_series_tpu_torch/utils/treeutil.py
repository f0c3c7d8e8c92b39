"""Tree utilities: the torch twin of ``yet_another_mobilenet_series_tpu/utils/treeutil.py``.

A tree here is a nested dict of tensors (the port's params, BN state and
optimizer buffers), its structure the sorted ``/``-joined paths of its
leaves (``models/convert.py`` ``flatten_tree``), which is what JAX's tree
structure of the same dict compares.
"""

from __future__ import annotations

from ..models.convert import flatten_tree


def tree_structure(tree) -> tuple[str, ...] | None:
    """The sorted leaf paths of a nested dict; None for anything else."""
    return tuple(sorted(flatten_tree(tree))) if isinstance(tree, dict) else None


def map_params_shaped(obj, params_structure: tuple[str, ...], fn):
    """Applies ``fn`` to every subtree of ``obj`` whose structure equals
    ``params_structure`` (:func:`tree_structure` of the params), recursing
    through dicts, lists and tuples; other leaves pass through. The port's
    optimizer state, ``{'count', 'nu', 'trace'}`` (``train/optim.py``),
    keeps its params-shaped buffers beside the count, so this finds them
    without knowing the optimizer."""
    if tree_structure(obj) == params_structure:
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_params_shaped(v, params_structure, fn) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_params_shaped(v, params_structure, fn) for v in obj)
    return obj
