"""Parameter partitioning for partial (LoRA-only) training (port of
``repro/optim/partition.py``) on nested dicts.

Only the trainable subtree is differentiated: the loss merges the two
trees, so frozen leaves get no gradient and no optimizer state.  A
partitioned tree keeps every key; the leaves of the other side are None.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple


def tree_map(fn, *trees, path=()):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in t0}
    return fn(path, *trees)


def trainable_mask(params: Any, predicate: Callable[[Tuple], bool]) -> Any:
    """A tree of bools from a path predicate; ``predicate`` receives the
    tuple of keys, e.g. ``('layers', 'attn', 'lora', 'q', 'a')``."""
    return tree_map(lambda path, _: bool(predicate(path)), params)


def lora_predicate(path: Tuple[str, ...]) -> bool:
    """The paper's trainable set: conditional-LoRA deltas + <COMP> embed."""
    return "lora" in path or "comp_embed" in path


def partition(params: Any, mask: Any) -> Tuple[Any, Any]:
    train = tree_map(lambda _, p, m: p if m else None, params, mask)
    frozen = tree_map(lambda _, p, m: None if m else p, params, mask)
    return train, frozen


def merge(train: Any, frozen: Any) -> Any:
    return tree_map(lambda _, t, f: f if t is None else t, train, frozen)


def leaves(tree: Any):
    """(path, leaf) pairs of the non-None leaves, in key order."""
    out = []
    tree_map(lambda path, x: out.append((path, x)) if x is not None else None,
         tree)
    return out
