"""Model and object persistence in the JAX package's format 1 (port of
``bigdl_tpu/utils/file_io.py``), so each package reads the other's
checkpoints.

A file is one pickle of plain builtins and numpy arrays, written through
``bigdl_tpu_torch.utils.fs`` (write, then rename).  A model file is::

    {"format": "bigdl_tpu.module", "version": 1,
     "spec": {"class": "<module>:TransformerLM", "state": {...}},
     "params": <numpy tree>, "buffers": <numpy tree>}

The spec's ``state`` holds the hyperparameters by name (a nested module,
such as a ``TransformerLM``'s ``_mha``, as its own spec) and a
container's spec its ``children``.  The port writes its own class paths;
it rebuilds a module from a spec written by either package by the
class's name (any port ``Module``: the ``nn`` layers, the
initialization methods, ``TransformerLM``) and the hyperparameters'
keys, and never imports the writer's module.  Optimizer state is numpy
in the reference's tree layout, with ``iteration`` a 0-d ``np.int32`` as
JAX writes it.
"""
from __future__ import annotations

import copy
import pickle
from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.attention import ATTENTION_IMPLS
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import fs
from bigdl_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map

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
_PLAIN = (int, float, bool, str, bytes, type(None), np.ndarray, np.generic)
#: OO-shell state that is not a hyperparameter (rebuilt fresh on load)
_SHELL_ATTRS = {"params", "buffers", "grad_params", "output", "grad_input",
                "forward_time", "backward_time", "modules", "device",
                "quant_report"}
_SHELL_PREFIXES = ("_jit", "_rng", "_vjp", "_fwd", "_step")


def _is_plain(v) -> bool:
    if isinstance(v, _PLAIN):
        return True
    if isinstance(v, (tuple, list)):
        return all(_is_plain(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, (str, int)) and _is_plain(x)
                   for k, x in v.items())
    return False


def _class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _port_classes() -> dict:
    """Every class a spec may name, by its bare name: the ``nn`` layers,
    criterions and initialization methods, and ``TransformerLM``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.transformer import TransformerLM
    out = {k: v for k, v in vars(nn).items() if isinstance(v, type)}
    out["TransformerLM"] = TransformerLM
    return out


def _resolve_class(path: str) -> type:
    name = path.partition(":")[2].rsplit(".", 1)[-1]
    cls = _port_classes().get(name)
    if cls is None:
        raise ValueError(f"cannot rebuild {path!r}: the port has no class "
                         f"named {name!r}")
    return cls


def _encode_value(v):
    from bigdl_tpu_torch.nn.module import Criterion, Module
    if isinstance(v, torch.Tensor):
        return params_to_numpy(v)
    if isinstance(v, Module):
        return {"__kind__": "module", **module_spec(v)}
    if isinstance(v, Criterion):
        return {"__kind__": "object", "class": _class_path(type(v)),
                "state": _encode_state(v.__dict__)}
    if isinstance(v, type):
        return {"__kind__": "class", "class": _class_path(v)}
    if isinstance(v, (tuple, list)):
        if _is_plain(v):
            return v
        return {"__kind__": "tuple" if isinstance(v, tuple) else "list",
                "items": [_encode_value(x) for x in v]}
    if isinstance(v, dict) and not _is_plain(v):
        return {"__kind__": "dict",
                "items": {k: _encode_value(x) for k, x in v.items()}}
    if _is_plain(v):
        return v
    raise TypeError(f"cannot serialize hyperparameter of type "
                    f"{type(v).__name__}")


def _decode_value(v, device):
    if isinstance(v, dict) and "__kind__" in v:
        kind = v["__kind__"]
        if kind == "module":
            return build_module(v, device)
        if kind == "object":
            cls = _resolve_class(v["class"])
            obj = cls.__new__(cls)
            obj.__dict__.update(_decode_state(v["state"], device))
            return obj
        if kind == "class":
            return _resolve_class(v["class"])
        if kind in ("tuple", "list"):
            items = [_decode_value(x, device) for x in v["items"]]
            return tuple(items) if kind == "tuple" else items
        if kind == "dict":
            return {k: _decode_value(x, device)
                    for k, x in v["items"].items()}
        raise ValueError(f"unknown encoded kind {kind!r}")
    return v


def _encode_state(d: dict) -> dict:
    from bigdl_tpu_torch.nn.module import Criterion, Module
    out = {}
    for k, v in d.items():
        if k in _SHELL_ATTRS or k.startswith(_SHELL_PREFIXES):
            continue
        if callable(v) and not isinstance(v, (type, Module, Criterion)):
            if k.startswith("_"):
                continue  # private machinery, rebuilt lazily
            raise TypeError(
                f"cannot serialize callable hyperparameter {k!r} "
                f"({type(v).__name__}): hold a Module or a class instead")
        out[k] = _encode_value(v)
    return out


def _decode_state(d: dict, device) -> dict:
    return {k: _decode_value(v, device) for k, v in d.items()}


def _lm_spec(model) -> dict:
    """A ``TransformerLM``'s spec: its hyperparameters, the attention's
    under ``_mha`` as the reference nests them."""
    mha = model._mha
    state = {k: getattr(model, k) for k in _LM_HYPER}
    state["_mha"] = {
        "__kind__": "module",
        "class": _class_path(type(mha)),
        "state": {"hidden_size": mha.hidden_size, "n_head": mha.n_head,
                  "head_dim": mha.head_dim, "causal": mha.causal,
                  "with_bias": mha.with_bias,
                  "attention_impl": mha.attention_impl}}
    return {"class": _class_path(type(model)), "state": state}


def module_spec(model) -> dict:
    """The declarative spec of a port module: its class path, its
    hyperparameters and (a container) its children's specs."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    if isinstance(model, TransformerLM):
        return _lm_spec(model)
    spec = {"class": _class_path(type(model)),
            "state": _encode_state(model.__dict__)}
    children = getattr(model, "modules", None)
    if children is not None:
        spec["children"] = [module_spec(m) for m in children]
    return spec


def build_module(spec: dict, device=None):
    """A fresh, unbuilt port module from a spec written by either
    package: each class is matched by name, the hyperparameters by key
    (a ``TransformerLM`` takes the keys it knows and ignores the rest)."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.module import Module
    cls = _resolve_class(spec["class"])
    state = spec["state"]
    if cls is TransformerLM:
        kw = {k: state[k] for k in _LM_HYPER if k in state}
        impl = state.get("_mha", {}).get("state", {}).get("attention_impl")
        if impl in ATTENTION_IMPLS:
            kw["attention_impl"] = impl
        return TransformerLM(device=device, **kw)
    obj = cls.__new__(cls)
    Module.__init__(obj)  # baseline shell state
    obj.__dict__.update(_decode_state(state, device))
    if "children" in spec:
        obj.modules = [build_module(s, device) for s in spec["children"]]
    return obj


def _param_shapes(model) -> dict:
    """The model's parameter tree as shapes: its params' when it has
    them, else an init's (a ``TransformerLM``'s on the meta device, no
    values drawn)."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    if model.params is not None:
        return tree_map(lambda a: tuple(a.shape), model.params)
    if not isinstance(model, TransformerLM):
        from bigdl_tpu_torch.utils.keychain import prng_key
        return tree_map(lambda a: tuple(np.shape(a)), model.init(prng_key(0)))
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
    module, built or not) the arrays go into it, on its device when it
    has one, and the spec is not read; its tree and shapes must match.
    Without one the spec rebuilds the module by class name on ``device``
    (default ``"cuda"``)."""
    state = load(path)
    if not (isinstance(state, dict) and state.get("format") == FORMAT):
        raise ValueError(f"{path} is not a format-{VERSION} module file")
    if state["version"] > VERSION:
        raise ValueError(f"checkpoint version {state['version']} is newer "
                         f"than this library ({VERSION})")
    model = template if template is not None else build_module(
        state["spec"], device)
    _check_tree(state["params"], _param_shapes(model))
    if model.device is None:
        model.device = resolve_device(device)
    model.params = params_from_numpy(state["params"], model.device)
    model.buffers = params_from_numpy(state["buffers"] or {}, model.device)
    return model
