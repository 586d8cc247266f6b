"""Helpers over the feature and output trees the port passes around: a
tensor, a numpy array, or a dict/list/tuple of them (the torch side of
``elasticdl_tpu/utils/tree_utils.py``'s pytrees)."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import torch


def map_tree(fn, tree):
    """``fn`` applied to every leaf of ``tree``, in the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in ``map_tree``'s order."""
    leaves: list = []
    map_tree(leaves.append, tree)
    return leaves


def stack_trees(trees: list, join=np.stack):
    """Trees of one structure as one tree whose leaves are ``join`` of the
    trees' leaves: stacked on a new leading axis (``np.stack``), or, with
    ``np.concatenate``, their rows one after another."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees], join) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            stack_trees([t[i] for t in trees], join) for i in range(len(first))
        )
    return join([np.asarray(t) for t in trees])


def batch_rows(tree) -> int:
    """The leading (batch) dimension of ``tree``'s first leaf."""
    leaf = tree_leaves(tree)[0]
    return int(np.shape(leaf)[0]) if np.ndim(leaf) else 1


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """A host numpy copy; bf16 keeps its bits as ``ml_dtypes.bfloat16``,
    the dtype the JAX package's arrays come back in."""
    host = tensor.detach().cpu()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return host.numpy()
