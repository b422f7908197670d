"""Checkpoint loading: the JAX package's ``.npz`` parameter files.

``save_params`` of ``lowbit_quant_fa2_paddle_tpu/utils/checkpoint.py``
flattens a parameter tree into keys joined by ``"__"`` (list indices as
numbers, e.g. ``blocks__0__wq``); :func:`load_params_npz` rebuilds the
nested tree of numpy arrays that the port's ``params_from_jax`` functions
take. numpy only.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"list keys are not 0..{len(idx) - 1}: {idx}")
        return [_listify(node[k]) for k in idx]
    return {k: _listify(v) for k, v in node.items()}


def load_params_npz(path: str) -> Dict[str, Any]:
    """The nested parameter tree of a ``save_params`` ``.npz`` file."""
    tree: Dict[str, Any] = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            *parents, leaf = key.split("__")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.array(data[key])
    return _listify(tree)
