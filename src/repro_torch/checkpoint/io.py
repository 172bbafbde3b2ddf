"""Flat-pytree checkpointing: .npz payload + json manifest.

Works on the framework's flat-dict param/opt-state trees. Nested dicts are
flattened with '::' separators; dtypes/shapes round-trip exactly. Atomic
write (tmp + rename) so a crashed run never leaves a torn checkpoint.

The format is the reference package's, so a checkpoint written by either
package loads in the other. ``save_checkpoint`` takes torch tensors (on
any device) or NumPy arrays as leaves and moves each tensor to host NumPy;
a dtype NumPy cannot hold (bfloat16) raises. ``load_checkpoint`` returns
NumPy arrays (``repro_torch.weights.params_from_jax`` puts params on a
device).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}::"))
    else:
        out[prefix[:-2]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("::")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_checkpoint(path: str, tree: Any, meta: Dict[str, Any] | None = None
                    ) -> None:
    def to_host(t):
        if isinstance(t, dict):
            return {k: to_host(v) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype == torch.bfloat16:
            raise TypeError("save_checkpoint: a bfloat16 leaf cannot be "
                            "stored, NumPy has no bfloat16; cast it first")
        return t.detach().cpu().numpy()

    os.makedirs(path, exist_ok=True)
    flat = _flatten(to_host(tree))
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    manifest = {
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "meta": meta or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in manifest["keys"]}
    return _unflatten(flat), manifest["meta"]
