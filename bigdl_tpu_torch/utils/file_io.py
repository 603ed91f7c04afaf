"""Model and object persistence in the JAX package's format 1 (port of
``bigdl_tpu/utils/file_io.py``), so each package reads the other's
checkpoints.

A file is one pickle of plain builtins and numpy arrays, written through
``bigdl_tpu_torch.utils.fs`` (write, then rename).  A model file is::

    {"format": "bigdl_tpu.module", "version": 1,
     "spec": {"class": "<module>:TransformerLM", "state": {...}},
     "params": <numpy tree>, "buffers": <numpy tree>}

The spec's ``state`` holds the hyperparameters by name, and ``_mha`` the
attention's spec.  The port writes its own class path; it rebuilds a
``TransformerLM`` from a spec written by either package by the class's
name and the hyperparameters' keys, and never imports the writer's
module.  Optimizer state is numpy in the reference's tree layout, with
``iteration`` a 0-d ``np.int32`` as JAX writes it.
"""
from __future__ import annotations

import copy
import pickle
from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import ATTENTION_IMPLS
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import fs
from bigdl_tpu_torch.utils.params import (params_from_numpy, params_to_numpy,
                                          tree_leaves, tree_map)

FORMAT = "bigdl_tpu.module"
VERSION = 1

#: the TransformerLM hyperparameters a spec carries, by attribute name
_LM_HYPER = ("vocab_size", "hidden_size", "n_head", "n_layers", "ffn_size",
             "max_len", "dropout", "tie_embeddings", "remat", "pos_encoding",
             "rope_base", "moe_experts", "moe_capacity_factor",
             "moe_aux_weight", "doc_start_id")


# --------------------------------------------------------------------- #
# generic object IO (driver state and the like: plain data only)        #
# --------------------------------------------------------------------- #
def save(obj: Any, path: str, overwrite: bool = False) -> int:
    """Pickle ``obj`` to ``path``; returns the bytes written."""
    if fs.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists; pass overwrite=True")
    data = pickle.dumps(obj)
    fs.atomic_write(path, data)
    return len(data)


def load(path: str) -> Any:
    with fs.open_file(path, "rb") as f:
        return pickle.load(f)


def latest_checkpoint(directory: str):
    """The newest complete ``model.<n>`` / ``state.<n>`` pair under
    ``directory`` as ``(model_path, state_path, n)``, or None when there
    is none (a missing directory included)."""
    try:
        names = fs.listdir(directory)
    except FileNotFoundError:
        return None
    models, states = set(), set()
    for name in names:
        stem, _, idx = name.partition(".")
        if not idx.isdigit():
            continue
        if stem == "model":
            models.add(int(idx))
        elif stem == "state":
            states.add(int(idx))
    complete = sorted(models & states)
    if not complete:
        return None
    n = complete[-1]
    return (fs.join(directory, f"model.{n}"),
            fs.join(directory, f"state.{n}"), n)


# --------------------------------------------------------------------- #
# optimizer state                                                       #
# --------------------------------------------------------------------- #
def state_to_numpy(state: dict) -> dict:
    """An optimizer method's state for the file: tensors to numpy, the
    host ``iteration`` to a 0-d ``np.int32``."""
    out = {}
    for k, v in state.items():
        if k == "iteration":
            out[k] = np.asarray(int(v), np.int32)
        elif isinstance(v, (dict, torch.Tensor)):
            out[k] = params_to_numpy(v)
        else:
            out[k] = v
    return out


def state_from_numpy(state: dict, device) -> dict:
    """The inverse of :func:`state_to_numpy` (either package's file):
    ``iteration`` back to a host int, arrays to tensors on ``device``."""
    out = {}
    for k, v in state.items():
        if k == "iteration":
            out[k] = int(np.asarray(v))
        elif isinstance(v, (dict, np.ndarray)):
            out[k] = params_from_numpy(v, device)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------- #
# module IO                                                             #
# --------------------------------------------------------------------- #
def module_spec(model) -> dict:
    """The spec of a port ``TransformerLM``: its class path and its
    hyperparameters, the attention's under ``_mha`` as the reference
    nests them."""
    mha = model._mha
    state = {k: getattr(model, k) for k in _LM_HYPER}
    state["_mha"] = {
        "__kind__": "module",
        "class": f"{type(mha).__module__}:{type(mha).__qualname__}",
        "state": {"hidden_size": mha.hidden_size, "n_head": mha.n_head,
                  "head_dim": mha.head_dim, "causal": mha.causal,
                  "with_bias": mha.with_bias,
                  "attention_impl": mha.attention_impl}}
    return {"class": f"{type(model).__module__}:{type(model).__qualname__}",
            "state": state}


def build_module(spec: dict, device=None):
    """A fresh, unbuilt port ``TransformerLM`` from a spec written by
    either package: the class is matched by name, the hyperparameters by
    key (keys the port does not know are ignored)."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    name = spec["class"].partition(":")[2].rsplit(".", 1)[-1]
    if name != "TransformerLM":
        raise ValueError(f"cannot rebuild {spec['class']!r}: the port "
                         f"loads TransformerLM checkpoints only")
    state = spec["state"]
    kw = {k: state[k] for k in _LM_HYPER if k in state}
    impl = state.get("_mha", {}).get("state", {}).get("attention_impl")
    if impl in ATTENTION_IMPLS:
        kw["attention_impl"] = impl
    return TransformerLM(device=device, **kw)


def _param_shapes(model) -> dict:
    """The model's parameter tree as shapes: its params' when it has
    them, else an init's on the meta device (no values drawn)."""
    if model.params is not None:
        return tree_map(lambda a: tuple(a.shape), model.params)
    meta = copy.copy(model)
    meta.device = torch.device("meta")
    with torch.device("meta"):
        tree = meta.init(torch.Generator())
    return tree_map(lambda a: tuple(a.shape), tree)


def _check_tree(params: dict, want: dict, path: str = "") -> None:
    if isinstance(want, dict):
        if not isinstance(params, dict) or set(params) != set(want):
            got = sorted(params) if isinstance(params, dict) else "a leaf"
            raise ValueError(f"checkpoint param tree does not match the "
                             f"model at {path or '/'}: keys {got} vs "
                             f"{sorted(want)}")
        for k in want:
            _check_tree(params[k], want[k], f"{path}/{k}")
        return
    if tuple(np.shape(params)) != want:
        raise ValueError(f"checkpoint param {path} has shape "
                         f"{tuple(np.shape(params))}, the model expects "
                         f"{want}")


def save_module(model, path: str, overwrite: bool = False) -> int:
    """Write spec + params + buffers (format 1); returns the bytes
    written.  A quantized clone is refused: save the float model."""
    if model.params is None:
        raise ValueError("the model has no params to save: build it first")
    if any(is_qtensor(leaf) for leaf in tree_leaves(model.params)):
        raise TypeError("quantized params have no format-1 encoding; save "
                        "the float model and quantize after loading")
    state = {
        "format": FORMAT,
        "version": VERSION,
        "spec": module_spec(model),
        "params": params_to_numpy(model.params),
        "buffers": params_to_numpy(model.buffers or {}),
    }
    return save(state, path, overwrite=overwrite)


def load_module(path: str, template=None, device=None):
    """Load a model saved by either package.  With ``template`` (a port
    ``TransformerLM``, built or not) the arrays go into it on its device
    and the spec is not read; its tree and shapes must match.  Without
    one the spec rebuilds a ``TransformerLM`` on ``device`` (default
    ``"cuda"``)."""
    state = load(path)
    if not (isinstance(state, dict) and state.get("format") == FORMAT):
        raise ValueError(f"{path} is not a format-{VERSION} module file")
    if state["version"] > VERSION:
        raise ValueError(f"checkpoint version {state['version']} is newer "
                         f"than this library ({VERSION})")
    model = template if template is not None else build_module(
        state["spec"], device)
    _check_tree(state["params"], _param_shapes(model))
    model.params = params_from_numpy(state["params"], model.device)
    model.buffers = params_from_numpy(state["buffers"] or {}, model.device)
    return model
