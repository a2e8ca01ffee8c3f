"""Cache trees: the nested dicts and lists of tensors that hold a model's
KV caches and recurrent state, and the snapshots and packets made of
them.  The one place that walks them leaf by leaf.

An encoder-decoder's decoder blocks also hold a ``cross`` entry: the
encoder's keys, dense per row in every layout, written by a prefill and
then only read.  The walks that invalidate, page, swap or reset KV
(``Model.invalidate_cache_after``, ``CoLLM.invalidate_rows_after``,
``Model.reset_state``) touch ``self`` entries and recurrent state only,
as the JAX package skips ``"cross"``."""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

Tree = Any


def map_tensors(tree: Tree, fn: Callable,
                is_leaf: Optional[Callable[[Tree], bool]] = None) -> Tree:
    """``tree`` rebuilt with ``fn`` applied to every leaf: every tensor, or
    with ``is_leaf`` every node it accepts.  Dicts, lists and tuples are
    walked; anything else is kept as it is."""
    if is_leaf(tree) if is_leaf is not None else isinstance(tree,
                                                            torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn, is_leaf) for v in tree)
    return tree


def map_named(tree: Tree, fn: Callable[[str, torch.Tensor], Any]) -> Tree:
    """A tree of nested dicts rebuilt with ``fn(key, leaf)`` applied to
    every tensor, ``key`` the leaf's own key (``"S"``, ``"conv"``, ...)."""
    return {k: map_named(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def commit(cache: Tree, new: Tree,
           mask: Optional[torch.Tensor] = None) -> Tree:
    """Write the ``new`` state tree into ``cache`` in place; with ``mask``
    (B,) the rows whose mask is False keep their old values bit for bit
    (the batch axis is axis 0 of every leaf)."""
    for key, old in cache.items():
        val = new[key]
        if isinstance(old, dict):
            commit(old, val, mask)
            continue
        val = val.to(old.dtype)
        if mask is not None:
            val = torch.where(mask.view(-1, *([1] * (old.dim() - 1))), val,
                              old)
        old.copy_(val)
    return cache


def zero(tree: Tree) -> Tree:
    """Zero every tensor of ``tree`` in place."""
    map_tensors(tree, torch.Tensor.zero_)
    return tree


def cache_bytes(tree: Tree) -> int:
    """Device bytes of every tensor of a cache tree: KV pages or rings,
    their scales and position markers, and recurrent state."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    children = tree.values() if isinstance(tree, dict) else tree
    return sum(cache_bytes(c) for c in children)
