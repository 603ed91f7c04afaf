"""Import PyTorch checkpoints into bigdl_tpu_torch models (port of
``bigdl_tpu/utils/torch_import.py``).

Today's pretrained checkpoints are PyTorch state dicts, so "switch from
the source framework and keep your weights" means mapping a
``model.state_dict()`` onto a module tree (the role of the reference's
example/loadmodel/ModelValidator.scala and CaffeLoader.scala:61-75).

Mapping model: both frameworks enumerate parameterized modules in
definition order — a torch ``nn.Module``'s ``state_dict()`` preserves
registration order, and a container walks its children in forward order
— so the i-th torch parameter GROUP (all entries sharing a key prefix:
``layer1.0.conv1.{weight,bias}``) corresponds to the i-th parameterized
leaf.  Weight layouts agree by construction (Linear ``(out, in)``, conv
``OIHW``, transposed conv ``(in, out, kh, kw)``), so the copy is
shape-checked but transformation-free; BatchNorm running statistics land
in the buffer tree; recurrent cells take torch's ``(gH, in)`` weights
transposed into the fused ``(in, gH)`` layout.

Import writes each value into the model's existing tensor, on the
model's device and in that tensor's dtype (a bfloat16 checkpoint is
widened to float32 on the host first).  Export emits the reference's
keys in the reference's order: each leaf's parameters in definition
order, recovered from a direct ``init`` call (the live tree's dict order
is sorted once a tree walk has rebuilt it).

The positional contract requires the torch twin to declare its modules
in forward order (true for torchvision-style models).  A count or shape
mismatch raises with both sides' inventories — the same contract
``CaffeLoader.load(match_all=true)`` enforces.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils import keychain

log = logging.getLogger("bigdl_tpu_torch.torch_import")


#: state-dict entries that carry no weight data
_IGNORED_SUFFIXES = ("num_batches_tracked",)
#: suffixes that land in the buffer tree instead of params
_BUFFER_SUFFIXES = ("running_mean", "running_var")


def _to_numpy(v) -> np.ndarray:
    """Torch tensors, numpy arrays or anything array-like as numpy on
    the host; a dtype numpy cannot hold (bfloat16 checkpoints are
    common) is widened to float32, which the copy casts to the model
    leaf's dtype anyway."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def chunked_device_array(a, dtype=None, limit_bytes=32 << 20, force=False,
                         *, device=None, out=None):
    """A device tensor from host data, copied in leading-axis slices of
    at most ``limit_bytes`` (32 MB), one at a time, into one
    preallocated tensor: ``out`` when given (its dtype wins; the slices
    are cast into it), else a new one on ``device`` (default the card).
    Small arrays, 0-d ones and a CPU target take one copy unless
    ``force``."""
    from bigdl_tpu_torch.device import resolve_device
    a = np.asarray(a, dtype) if dtype is not None else np.asarray(a)
    src = torch.from_numpy(np.ascontiguousarray(a))
    dev = out.device if out is not None else resolve_device(device)
    if out is None:
        out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    elif tuple(out.shape) != tuple(src.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit a tensor "
                         f"of shape {tuple(out.shape)}")
    with torch.no_grad():
        if not force and (a.ndim == 0 or a.nbytes <= limit_bytes
                          or dev.type == "cpu"):
            out.copy_(src)
            return out
        rows = max(1, limit_bytes // max(a[0:1].nbytes, 1))
        for i in range(0, a.shape[0], rows):
            out[i:i + rows].copy_(src[i:i + rows])
    return out


def read_torch_checkpoint(path):
    """``torch.load`` a checkpoint file (``weights_only=True``) and
    unwrap the common trainer wrapper keys ('state_dict', 'model') down
    to the flat state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and key in obj and not hasattr(obj[key], "shape"):
            inner = obj[key]
            if isinstance(inner, dict):
                obj = inner
                break
    return obj


def group_state_dict(state_dict) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Group flat ``{key: tensor}`` entries by module prefix, in order of
    first appearance: ``layer1.0.conv1.weight`` -> prefix
    ``layer1.0.conv1``, leaf ``weight``."""
    groups: List[Tuple[str, Dict[str, np.ndarray]]] = []
    index: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in _IGNORED_SUFFIXES:
            continue
        if prefix not in index:
            index[prefix] = {}
            groups.append((prefix, index[prefix]))
        index[prefix][leaf] = _to_numpy(value)
    return groups


def _walk_leaves(module, params, buffers, path, proto=None):
    """Yield (path, module, param_dict, buffer_dict, param_proto) for
    every parameterized or buffer-holding LEAF module, in forward order.
    The yielded dicts are the live sub-dicts of the params/buffers
    trees; ``param_proto`` is the leaf's definition-order key structure
    when a nested descent already computed it (None = compute lazily if
    needed)."""
    children = getattr(module, "modules", None)
    if children:
        # containers key children "0", "1", ... (Container.init);
        # wrapper modules (TimeDistributed, Recurrent, BiRecurrent) use
        # named keys
        keys = _child_keys(module)
        for key, child in zip(keys, children):
            yield from _walk_leaves(
                child,
                (params or {}).get(key, {}),
                (buffers or {}).get(key, {}),
                f"{path}.{key}" if path else key)
        return
    if params and all(isinstance(v, dict) for v in params.values()):
        # nested leaf params (Scale's {cmul: {...}, cadd: {...}}): each
        # sub-dict is its own positional group, in DEFINITION order
        ptree = proto if proto is not None else _init_proto(module)
        for k in _ordered_keys(params, ptree, module, "nested param group"):
            sub = ptree.get(k) if isinstance(ptree, dict) else None
            yield from _walk_leaves(module, params[k],
                                    (buffers or {}).get(k, {}),
                                    f"{path}.{k}" if path else k,
                                    proto=sub)
        return
    if params or buffers:
        yield path, module, params, buffers, proto


def _init_proto(module):
    """The definition-order key structure of ``module.init``, from a
    direct init call (the reference's key chain at seed 0; the values
    are dropped).  None when init fails out of context."""
    try:
        return module.init(keychain.prng_key(0))
    except Exception:
        return None


def _ordered_keys(keys, proto, module, what) -> List[str]:
    """``keys`` in proto's definition order; the alphabetical fallback
    is LOUD — silent alphabetical ordering is exactly the weight/bias
    swap hazard this machinery exists to prevent."""
    if proto is None:
        log.warning(
            "definition order unavailable for %s (init failed out of "
            "context): exporting its %s in alphabetical order — verify "
            "any positional rename onto a torch module by shape",
            type(module).__name__, what)
        return sorted(keys)
    order = {k: i for i, k in enumerate(proto)}
    return sorted(keys, key=lambda k: (order.get(k, len(order)), k))


def _child_keys(module) -> List[str]:
    """Param-tree keys for a composite's children, in child order."""
    from bigdl_tpu_torch import nn
    if isinstance(module, nn.TimeDistributed):
        return ["module"]
    if isinstance(module, nn.Recurrent):
        return ["cell"]
    if isinstance(module, nn.BiRecurrent):
        return ["fwd", "bwd"]
    return [str(i) for i in range(len(module.modules))]


def load_torch_state_dict(model, state_dict, *, strict: bool = True):
    """Copy a PyTorch ``state_dict`` into ``model``'s params/buffers, each
    value into the existing tensor (its device and dtype).

    ``model`` must be built (``model.build(seed)``); returns the model.
    With ``strict`` (default, = the reference's ``match_all``) the group
    count must match exactly; otherwise the common prefix is copied.
    """
    from bigdl_tpu_torch.utils.params import params_from_numpy
    params = model._built()
    if not model.buffers:
        model.buffers = params_from_numpy(model.init_buffers(),
                                          model._device())
    buffers = model.buffers

    ours = list(_walk_leaves(model, params, buffers, ""))
    theirs = group_state_dict(state_dict)
    if len(ours) != len(theirs):
        if strict:
            raise ValueError(
                f"module count mismatch: model has {len(ours)} "
                f"parameterized leaves, state_dict has {len(theirs)} "
                f"groups\n{_inventory(ours, theirs)}")
        # strict=False truncates to the common positional prefix — say
        # exactly what fell off each side, because a count mismatch
        # usually means the alignment SHIFTED somewhere earlier
        n = min(len(ours), len(theirs))
        unmatched_ours = [
            f"{path or '<root>'} ({type(m).__name__}"
            f"{sorted(p) + sorted(b)})"
            for path, m, p, b, _pr in ours[n:]]
        unmatched_theirs = [f"{prefix} ({sorted(g)})"
                            for prefix, g in theirs[n:]]
        log.warning(
            "strict=False: copying the first %d positional groups; "
            "%d model leaves left unmatched: %s; %d state-dict groups "
            "left unmatched: %s — verify the matched prefix is really "
            "aligned (a skipped module shifts every later group)",
            n, len(unmatched_ours), unmatched_ours or "none",
            len(unmatched_theirs), unmatched_theirs or "none")
    pairs = []
    for (path, mod, p_leaf, b_leaf, _proto), (prefix, group) in zip(ours, theirs):
        group = _adapt_torch_rnn_group(mod, p_leaf, group, prefix, path)
        for leaf_name, value in group.items():
            target = b_leaf if leaf_name in _BUFFER_SUFFIXES else p_leaf
            if leaf_name not in target:
                raise ValueError(
                    f"{prefix}.{leaf_name}: {type(mod).__name__} at "
                    f"'{path}' has no matching slot "
                    f"(has {sorted(target)})")
            have = target[leaf_name]
            if tuple(have.shape) != tuple(value.shape):
                raise ValueError(
                    f"{prefix}.{leaf_name} -> {type(mod).__name__} at "
                    f"'{path}': shape {tuple(value.shape)} vs expected "
                    f"{tuple(have.shape)}")
            pairs.append((have, value))
    # every group is checked before the first tensor is written
    for have, value in pairs:
        chunked_device_array(value, out=have)
    return model


def _adapt_torch_rnn_group(mod, p_leaf, group, prefix, path):
    """Convert a torch ``nn.RNN/LSTM/GRU`` (or ``*Cell``) parameter
    group onto the recurrent-cell layout: torch stores
    ``weight_ih (gH, in)`` / ``weight_hh (gH, H)`` and TWO bias vectors
    where the cell stores transposed ``w_ih (in, gH)`` / ``w_hh (H, gH)``
    and one fused ``bias`` (= bias_ih + bias_hh; the gate orders agree:
    i|f|g|o for LSTM, r|z|n for GRU — for GRU torch's n-gate applies
    ``bias_hh`` inside the reset product, so a nonzero ``bias_hh_l*``
    n-slice cannot be represented exactly and is rejected)."""
    suffixes = {k.rsplit("_l", 1)[0] if "_l" in k else k: k
                for k in group}
    if not {"weight_ih", "weight_hh"} <= set(suffixes) or "w_ih" not in p_leaf:
        return group
    # reject multi-layer/bidirectional modules FIRST: their colliding
    # l0/l1/_reverse suffixes would otherwise trip the bias check below
    extra = set(group) - {suffixes[s] for s in
                          ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
                          if s in suffixes}
    if extra:
        raise ValueError(f"{prefix}: unsupported torch RNN entries "
                         f"{sorted(extra)} (multi-layer/bidirectional "
                         f"torch RNN modules import layer-by-layer)")
    H = p_leaf["w_hh"].shape[0]
    w_ih = group[suffixes["weight_ih"]].T
    w_hh = group[suffixes["weight_hh"]].T
    zeros = np.zeros(w_ih.shape[1], np.float32)
    # bias=False checkpoints carry no bias entries: the exact mapping is
    # a ZERO fused bias, not the model's random init
    b_ih = group.get(suffixes.get("bias_ih", ""), zeros)
    b_hh = group.get(suffixes.get("bias_hh", ""), zeros)
    if w_ih.shape[1] == 3 * H and np.any(b_hh[2 * H:]):
        raise ValueError(
            f"{prefix} -> {type(mod).__name__} at '{path}': torch GRU "
            f"applies bias_hh's n-gate slice inside the reset "
            f"product; a nonzero slice cannot map onto the fused "
            f"bias layout — retrain with bias_hh=0 or import "
            f"manually")
    return {"w_ih": w_ih, "w_hh": w_hh, "bias": b_ih + b_hh}


def load_torch_checkpoint(model, path: str, *, strict: bool = True):
    """Load a ``torch.save``d checkpoint file (a state dict, or a dict
    holding one under 'state_dict'/'model') into ``model``."""
    return load_torch_state_dict(model, read_torch_checkpoint(path),
                                 strict=strict)


def export_torch_state_dict(model) -> "dict":
    """The reverse direction: a built model's params/buffers as a flat
    PyTorch-convention state dict of host numpy arrays.  Keys are the
    model's own tree paths (``0.weight``, ``3.running_mean`` ...), which
    round-trip through :func:`load_torch_state_dict`'s positional
    contract (nested leaf params like Scale's export as
    ``i.cmul.weight``); loading into an actual torch module whose
    prefixes differ only needs a key rename, since the ORDER matches by
    the same definition-order contract."""
    if model.params is None:
        # exporting a fresh random init as if it were trained weights is
        # a wrong-output hazard
        raise ValueError("model has no params to export — call "
                         "model.build(seed) (or train it) first")
    buffers = model.buffers if model.buffers else model.init_buffers()
    out = {}
    for path, mod, p_leaf, b_leaf, proto in _walk_leaves(
            model, model.params, buffers, ""):
        # params in DEFINITION order (weight before bias, w_ih before
        # w_hh before bias, ...): a positional rename onto a torch twin
        # depends on it
        if len(p_leaf) > 1 and proto is None:
            proto = _init_proto(mod)
        names = (list(p_leaf) if len(p_leaf) < 2
                 else _ordered_keys(p_leaf, proto, mod, "params"))
        for name in names:
            out[f"{path}.{name}" if path else name] = _to_numpy(p_leaf[name])
        bproto = None
        if len(b_leaf) > 1:
            try:
                bproto = mod.init_buffers()
            except Exception:
                bproto = None
        bnames = (list(b_leaf) if len(b_leaf) < 2
                  else _ordered_keys(b_leaf, bproto, mod, "buffers"))
        for name in bnames:
            out[f"{path}.{name}" if path else name] = _to_numpy(b_leaf[name])
    return out


def _inventory(ours, theirs) -> str:
    left = [f"  model[{i}] {path or '<root>'}: {type(m).__name__}"
            f"{sorted(p) + sorted(b)}"
            for i, (path, m, p, b, _pr) in enumerate(ours)]
    right = [f"  torch[{i}] {prefix}: {sorted(g)}"
             for i, (prefix, g) in enumerate(theirs)]
    return "\n".join(left + right)
