"""Flat-key (de)serialization of nested parameter pytrees to .npz.

Checkpoint format: one .npz holding arrays under dot-joined keys plus a
``__meta__`` JSON string (architecture, units, bn, dims, ...). Replaces the
reference's whole-module torch pickles (topaz/training.py:596-603) with a
torch-free, framework-version-independent format.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, meta: Dict, **trees: Dict) -> None:
    """Save named pytrees (e.g. params=..., state=...) plus metadata."""
    flat = {}
    for name, tree in trees.items():
        for k, v in flatten_tree(tree).items():
            flat[f"{name}:{k}"] = v
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_checkpoint(path: str) -> Tuple[Dict, Dict[str, Dict]]:
    """Load (meta, {tree_name: pytree})."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        trees: Dict[str, Dict[str, np.ndarray]] = {}
        for key in z.files:
            if key == "__meta__":
                continue
            name, flat_key = key.split(":", 1)
            trees.setdefault(name, {})[flat_key] = z[key]
    return meta, {name: unflatten_tree(flat) for name, flat in trees.items()}
