"""Checkpoints in the JAX package's files: parameter ``.npz`` files and
quantized KV caches.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/utils/checkpoint.py`` in numpy
and torch only, writing and reading the same files:

* :func:`save_params` / :func:`load_params` — a flat ``.npz`` of a model's
  parameter tree as the JAX package lays it out (keys joined by ``"__"``,
  list indices as numbers, e.g. ``blocks__0__wq``; dense weights ``[in,
  out]``; bf16 widened to f32, which loses nothing), so JAX's
  ``load_params`` reads what :func:`save_params` writes and
  :func:`load_params` (through :func:`load_params_npz` and the models'
  ``params_from_jax``) reads what JAX's ``save_params`` writes;
* :func:`save_quantized_cache` / :func:`load_quantized_cache` — one layer's
  int8 KV cache (``ops/decode.py``'s dict) with codes that fit 4 bits packed
  two a byte by the port's host packer (``host.pack_int4``, the JAX
  package's algorithm), the others as they are, beside a ``.meta.json`` of
  each side's shape and packing: the arrays and the meta file are those
  JAX's functions write for the same cache.

The models' trees come from ``models/llm.py`` and ``models/dit.py``
(``params_to_jax``); packed-weight layers (``WQWeight``) have no place in
JAX's parameter files and raise.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


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
    with np.load(_npz(path)) as data:
        for key in data.files:
            *parents, leaf = key.split("__")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.array(data[key])
    return _listify(tree)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a__0__w": array}`` of a nested dict/list tree, in its order."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}__"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}__"))
    else:
        out[prefix[:-2]] = np.asarray(tree)
    return out


def _model_module(model: torch.nn.Module):
    from lowbit_quant_fa2_paddle_tpu_torch.models import dit, llm

    for mod in (llm, dit):
        cls = mod.LLM if mod is llm else mod.DiT
        if isinstance(model, cls):
            return mod
    raise TypeError(f"save_params / load_params take the port's LLM or DiT, not {type(model).__name__}")


def save_params(path: str, model: torch.nn.Module) -> None:
    """The JAX package's ``.npz`` parameter file of an LLM or a DiT (see the
    module note); numpy appends ``.npz`` to a path without it."""
    tree = _model_module(model).params_to_jax(model)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_params(path: str, like: torch.nn.Module) -> torch.nn.Module:
    """A model of ``like``'s class, config and device with the weights of a
    parameter file (the JAX package's or :func:`save_params`'), cast to the
    config's dtype as JAX's ``load_params`` casts to its template's."""
    mod = _model_module(like)
    device = next(like.parameters()).device
    return mod.params_from_jax(load_params_npz(path), like.cfg, device=device)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_quantized_cache(path: str, cache: Dict[str, torch.Tensor]) -> None:
    """Persist one layer's int8 KV cache (``k``, ``v``, ``k_scale``,
    ``v_scale``, ``length``): a side whose codes all lie in [-7, 7] (and
    whose rows have an even width) is packed to 4 bits by ``host.pack_int4``,
    any other side (int8 codes past ±7, a 4-bit cache's bytes) is stored as
    it is; a bf16 side raises (JAX's loader would make it int8). The
    ``.meta.json`` goes to ``path + ".meta.json"``, as JAX's function writes
    it (so JAX's loader finds it when ``path`` ends in ``.npz``)."""
    from lowbit_quant_fa2_paddle_tpu_torch import host

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blobs, meta = {}, {}
    for name in ("k", "v"):
        if cache[name].dtype != torch.int8:
            raise TypeError(f"save_quantized_cache takes int8 codes (8 or 4 bits a side), not {cache[name].dtype}")
        codes = cache[name].detach().cpu().numpy()
        shape = codes.shape
        fits_int4 = bool((codes >= -7).all() and (codes <= 7).all())
        if fits_int4 and shape[-1] % 2 == 0:
            blobs[name] = host.pack_int4(codes.reshape(-1, shape[-1]))
            meta[name] = {"shape": list(shape), "packed": True}
        else:
            blobs[name] = codes
            meta[name] = {"shape": list(shape), "packed": False}
    for name in ("k_scale", "v_scale", "length"):
        blobs[name] = cache[name].detach().cpu().numpy()
    np.savez(path, **blobs)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_quantized_cache(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """A cache that :func:`save_quantized_cache` (or JAX's function) wrote,
    as ``ops/decode.py``'s dict of tensors on ``device`` (the CUDA card
    unless the caller says otherwise): codes int8 (unpacked by
    ``host.unpack_int4`` where they were packed), scales f32, ``length``
    int32. The meta file is read from ``<path>.npz.meta.json``, as JAX's
    loader reads it."""
    from lowbit_quant_fa2_paddle_tpu_torch import host

    with np.load(_npz(path)) as data, open(_npz(path) + ".meta.json") as f:
        meta = json.load(f)
        out = {}
        for name in ("k", "v"):
            m = meta[name]
            codes = host.unpack_int4(data[name]).reshape(tuple(m["shape"])) if m["packed"] else data[name]
            out[name] = torch.from_numpy(np.asarray(codes, np.int8)).to(device)
        for name in ("k_scale", "v_scale", "length"):
            out[name] = torch.from_numpy(np.array(data[name])).to(device)
    return out
