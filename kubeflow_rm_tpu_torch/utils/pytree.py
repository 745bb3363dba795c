"""Small tree utilities over the port's nested dicts of tensors
(counterpart of ``kubeflow_rm_tpu/utils/pytree.py``).

A tree is a tensor, or a dict, list or tuple of trees, or a dataclass
instance whose fields are trees (an optimizer state); any other leaf (a
Python number, None) holds no parameters and is passed through.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, in insertion order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return []


def param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total in-memory size of a tree of tensors, in bytes."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating-point leaf of ``tree`` to ``dtype``; integer
    and boolean leaves (token ids, int8 weights) keep theirs."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    return tree
