"""Tree-level quantization transform with an include/exclude policy (port
of ``bigdl_tpu/quant/transform.py``).

``quantize_params`` walks a params tree and replaces eligible weight
leaves with :class:`~bigdl_tpu_torch.quant.qtensor.QTensor` (int8) or
bfloat16 tensors (bf16).  The defaults follow the reference's precision
rule: biases, norms below ``min_ndim`` and embedding tables (by name)
stay float; everything 2-D and above that is big enough is quantized,
with its scale over the second-to-last axis (the generic ``x @ w``
layout).  Stacking a transformer's blocks on a layer axis makes its
layer-norm weights 2-D, so they are quantized too, as in the reference,
and expanded at the entry seam (:func:`dequantize_entry`), since their
consumer reads them directly.

With ``module=`` the walk is owner-aware, as the reference's: a
``Linear``'s weight gets its native layout (per-output-channel scales,
reduced over ``in``) and a ``LookupTable``'s table is never quantized.
A ``SpatialConvolution``'s OIHW weight (grouped and dilated forms
included) gets per-output-plane scales, reduced over (I/g, kH, kW).
A transformer's leaves take the generic path in both
packages, so its trees quantize leaf for leaf alike.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.quant.qtensor import (COMPUTE_MODES, QTensor,
                                           dequantize_array, is_qtensor,
                                           quantize_array, torch_dtype)
from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map

#: leaf names never quantized: biases in every naming scheme (``bias``,
#: the stacked blocks' ``b1``/``bq``/...), norm affine leaves and
#: embedding / positional tables
_SKIP_NAME_RE = re.compile(r"^(bias|b\d*|b[qkvo]|beta|gamma|embed(ding)?"
                           r"|pos(_emb)?|wte|wpe)$")

#: non-native leaf names whose consuming product is QTensor-aware
#: (``kernels.qmatmul``: attention projections, MLP halves, the untied
#: head); only these may carry a compute mode past the entry seam
_COMPUTE_NAME_RE = re.compile(r"^(wq|wk|wv|wo|w1|w2|head)$")


def _compile(pattern):
    return re.compile(pattern) if isinstance(pattern, str) else pattern


def _effective_compute(compute: str, name: str, native: bool,
                       name_re) -> str:
    """``compute`` for a leaf named ``name``, or ``"dequant"`` for a
    non-native leaf without a QTensor-aware consumer (one that
    ``name_re`` does not match): its consumer reads params directly."""
    if compute != "dequant" and not native and not (
            name_re is not None and name_re.match(name)):
        return "dequant"
    return compute


class QuantPolicy:
    """Include/exclude policy for :func:`quantize_params`.

    Args:
        dtype: ``"int8"`` (QTensor storage) or ``"bf16"`` (plain cast).
        min_ndim: leaves below this rank are skipped.
        min_size: leaves with fewer elements are skipped.
        skip_name_re: regex on the leaf's own key.
        skip_path_re: optional regex on the ``/``-joined tree path.
        compute: what the consuming product does with int8 leaves:
            ``"dequant"`` (the default), ``"int8"``, ``"auto"`` or
            ``"fp8"`` (refused unless ``activations.fp8_supported()``).
        compute_name_re: which non-native leaf names may carry a
            non-dequant compute mode (the sites ``kernels.qmatmul``
            serves).
    """

    def __init__(self, dtype: str = "int8", *, min_ndim: int = 2,
                 min_size: int = 128,
                 skip_name_re=_SKIP_NAME_RE,
                 skip_path_re=None,
                 compute: str = "dequant",
                 compute_name_re=_COMPUTE_NAME_RE):
        if dtype not in ("int8", "bf16"):
            raise ValueError(f"unsupported quant dtype {dtype!r} "
                             "(int8 or bf16)")
        if compute not in COMPUTE_MODES:
            raise ValueError(f"unsupported compute mode {compute!r} "
                             "(dequant, int8, auto or fp8)")
        if compute != "dequant" and dtype != "int8":
            raise ValueError(f"compute={compute!r} needs dtype='int8' "
                             f"(got {dtype!r}): only int8 storage feeds "
                             "the low-precision products")
        if compute == "fp8":
            from bigdl_tpu_torch.quant.activations import fp8_supported
            if not fp8_supported():
                raise NotImplementedError(
                    "compute='fp8' is gated on fp8-capable device kinds; "
                    "this device is not one (int8 and dequant work "
                    "everywhere)")
        self.dtype = dtype
        self.compute = compute
        self.min_ndim = int(min_ndim)
        self.min_size = int(min_size)
        self.skip_name_re = _compile(skip_name_re)
        self.skip_path_re = _compile(skip_path_re)
        self.compute_name_re = _compile(compute_name_re)

    def wants(self, path: Tuple[str, ...], leaf) -> bool:
        """Should this leaf be quantized?  Only float tensors qualify."""
        name = path[-1] if path else ""
        if self.skip_name_re is not None and self.skip_name_re.match(name):
            return False
        if self.skip_path_re is not None \
                and self.skip_path_re.search("/".join(path)):
            return False
        if leaf.ndim < self.min_ndim or leaf.numel() < self.min_size:
            return False
        return leaf.is_floating_point()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _module_index(module) -> Dict[Tuple[str, ...], object]:
    """(tree path) -> owning leaf module, walking containers by their
    index keys."""
    index: Dict[Tuple[str, ...], object] = {}

    def walk(mod, path):
        children = getattr(mod, "modules", None)
        if children:
            for i, child in enumerate(children):
                walk(child, path + (str(i),))
            return
        index[path] = mod

    walk(module, ())
    return index


def _owner_of(index, leaf_path: Tuple[str, ...]):
    """Longest registered prefix of ``leaf_path`` (nested leaf params
    like Scale's {cmul, cadd} still belong to the Scale module)."""
    for n in range(len(leaf_path) - 1, -1, -1):
        mod = index.get(leaf_path[:n])
        if mod is not None:
            return mod
    return None


def _native_spec(owner, name: str):
    """(reduce_axes, native) when the owner dequantizes this leaf inside
    its own product; None for the generic handling; "skip" for an
    embedding table."""
    if owner is None:
        return None
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear, LookupTable
    if isinstance(owner, LookupTable):
        return "skip"
    if name != "weight":
        return None
    if isinstance(owner, SpatialConvolution):
        # OIHW: the contraction is over (I/g, kH, kW); the transposed and
        # map variants are other classes and take the generic path
        return (1, 2, 3), True
    if isinstance(owner, Linear):
        return (-1,), True  # (out, in): the contraction is over in
    return None


def quantize_params(params, dtype: str = "int8", *,
                    policy: Optional[QuantPolicy] = None,
                    module=None, report: Optional[dict] = None):
    """Quantize the eligible leaves of ``params``; returns a new tree
    (other leaves are shared).  ``module`` (the tree's owner) enables the
    owner-aware decisions: native scale layouts for ``Linear`` and
    ``SpatialConvolution`` and the exclusion of embedding tables.
    ``report`` (a dict) is filled with the byte counts, per-leaf max abs
    dequantization error and, for int8 or auto compute, each leaf's
    int32-accumulator overflow risk, under the reference's keys."""
    policy = policy or QuantPolicy(dtype)
    if policy.dtype != dtype:
        policy = QuantPolicy(dtype, min_ndim=policy.min_ndim,
                             min_size=policy.min_size,
                             skip_name_re=policy.skip_name_re,
                             skip_path_re=policy.skip_path_re,
                             compute=policy.compute,
                             compute_name_re=policy.compute_name_re)
    index = _module_index(module) if module is not None else {}
    per_layer_err: Dict[str, float] = {}
    per_layer_risk: Dict[str, float] = {}
    stats = {"bytes_orig": 0, "bytes_quant": 0,
             "quantized_leaves": 0, "skipped_leaves": 0}

    def transform(node, path: Tuple[str, ...]):
        if isinstance(node, dict):
            return {k: transform(v, path + (str(k),))
                    for k, v in node.items()}
        if is_qtensor(node):  # already quantized: idempotent pass
            stats["bytes_orig"] += (node.size
                                    * torch_dtype(node.orig_dtype).itemsize)
            stats["bytes_quant"] += node.nbytes
            stats["quantized_leaves"] += 1
            return node
        if not isinstance(node, torch.Tensor):
            return node
        stats["bytes_orig"] += _nbytes(node)
        name = path[-1] if path else ""
        spec = _native_spec(_owner_of(index, path), name)
        if spec == "skip" or not policy.wants(path, node):
            stats["bytes_quant"] += _nbytes(node)
            stats["skipped_leaves"] += 1
            return node
        stats["quantized_leaves"] += 1
        key = "/".join(path)
        if dtype == "bf16":
            out = node.to(torch.bfloat16)
            stats["bytes_quant"] += _nbytes(out)
            if report is not None:
                per_layer_err[key] = float(
                    (node - out.to(node.dtype)).abs().max())
            return out
        # else the generic x @ w layout (stacked blocks, the untied
        # head): the contraction is the second-to-last axis, every other
        # axis keeps its own scale
        reduce_axes, native = spec if spec is not None else ((-2,), False)
        compute = _effective_compute(policy.compute, name, native,
                                     policy.compute_name_re)
        qt = quantize_array(node, reduce_axes, native=native,
                            compute=compute)
        stats["bytes_quant"] += qt.nbytes
        if report is not None:
            per_layer_err[key] = float(
                (node - qt.dequantize(node.dtype)).abs().max())
            if compute in ("int8", "auto"):
                per_layer_risk[key] = _overflow_risk(qt, reduce_axes)
        return qt

    out = transform(params, ())
    if report is not None:
        report.update(stats)
        report["dtype"] = dtype
        report["compute_mode"] = policy.compute
        report["payload_ratio"] = (stats["bytes_quant"]
                                   / max(stats["bytes_orig"], 1))
        report["bytes_saved"] = stats["bytes_orig"] - stats["bytes_quant"]
        report["per_layer_max_abs_err"] = per_layer_err
        report["max_abs_dequant_error"] = (max(per_layer_err.values())
                                           if per_layer_err else 0.0)
        report["per_layer_overflow_risk"] = per_layer_risk
        report["overflow_risk"] = (max(per_layer_risk.values())
                                   if per_layer_risk else 0.0)
    return out


def publish_quant_report(report: dict) -> None:
    """The reference's ``quant/*`` registry gauges of one report."""
    from bigdl_tpu_torch.obs.registry import get_registry
    reg = get_registry()
    reg.gauge("quant/bytes_saved", unit="B").set(report["bytes_saved"])
    reg.gauge("quant/payload_ratio").set(report["payload_ratio"])
    reg.gauge("quant/max_abs_dequant_error").set(
        report["max_abs_dequant_error"])
    for path, err in report["per_layer_max_abs_err"].items():
        reg.gauge(f"quant/max_abs_dequant_error/{path}").set(err)
    if report.get("per_layer_overflow_risk"):
        reg.gauge("quant/overflow_risk").set(report["overflow_risk"])
        for path, risk in report["per_layer_overflow_risk"].items():
            reg.gauge(f"quant/overflow_risk/{path}").set(risk)


def _overflow_risk(qt: QTensor, reduce_axes) -> float:
    """Worst-case int32-accumulator fill of an int8 product: ``max|q_w| *
    127 * K / 2^31``, K the contraction length (127 bounds the
    activation by construction).  Near 1.0 a weight could wrap the
    accumulator."""
    shape = qt.shape
    axes = (tuple(reduce_axes) if reduce_axes is not None
            else tuple(range(len(shape))))
    k = 1
    for a in axes:
        k *= int(shape[a])
    qmax_w = int(qt.q.to(torch.int32).abs().max())
    return float(qmax_w) * 127.0 * float(k) / float(2 ** 31)


def dequantize_params(params, dtype=None):
    """Expand every QTensor back to a dense tensor (``dtype`` overrides
    each leaf's pre-quantization dtype).  bf16-cast leaves are not
    widened: the cast already lost the bits."""
    return tree_map(lambda n: dequantize_array(n, dtype)
                    if is_qtensor(n) else n, params)


def dequantize_entry(params):
    """The entry seam: expand non-native dequant-mode QTensors (their
    consumers read params directly) and pass everything else through;
    leaves in another compute mode reach the QTensor-aware products as
    int8.  The serving steps call it per layer (the expansion is
    elementwise, so per layer gives the whole tree's numbers), so a
    captured step holds one layer's float copy at a time."""
    return tree_map(lambda n: (n.dequantize()
                               if is_qtensor(n) and not n.native
                               and n.compute == "dequant" else n), params)


def set_compute_mode(params, compute: str, *,
                     compute_name_re=_COMPUTE_NAME_RE):
    """Rewrite the compute mode of an already-quantized tree, aux fields
    only: every QTensor of the result shares its ``q`` and ``scale``
    tensors with the input, nothing re-rounds.  The consumable-name
    guard of :func:`quantize_params` applies.  This is how an int8
    target becomes its own int8-compute drafter with one set of
    weights."""
    if compute not in COMPUTE_MODES:
        raise ValueError(f"compute must be 'dequant', 'int8', 'auto' or "
                         f"'fp8', got {compute!r}")
    name_re = _compile(compute_name_re)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if is_qtensor(node):
            eff = _effective_compute(compute, path[-1] if path else "",
                                     node.native, name_re)
            if eff != node.compute:
                return node.with_compute(eff)
        return node

    return walk(params, ())


_COMPUTE_RANK = {"dequant": 0, "auto": 1, "int8": 2, "fp8": 3}


def params_compute_tag(params) -> Optional[str]:
    """The dominant compute mode of a params tree ("fp8" > "int8" >
    "auto" > "dequant"; None when nothing is quantized)."""
    best = None
    for leaf in tree_leaves(params):
        if is_qtensor(leaf) and (best is None or _COMPUTE_RANK[leaf.compute]
                                 > _COMPUTE_RANK[best]):
            best = leaf.compute
    return best


def params_dtype_tag(params) -> str:
    """The quant dtype a params tree serves at: "int8" when any leaf is a
    QTensor, else "bf16" when any leaf is bfloat16, else "f32".  Part of
    the serving graph cache's key."""
    tag = "f32"
    for leaf in tree_leaves(params):
        if is_qtensor(leaf):
            return "int8"
        if getattr(leaf, "dtype", None) == torch.bfloat16:
            tag = "bf16"
    return tag


def stage_quantized_params(params, *, device):
    """Move the QTensor payloads to ``device`` and count the bytes that
    moved (int8 values plus scales: about 4x fewer than the float32
    they replace).  Returns ``(params, bytes_moved)``; other leaves stay
    where they are.  The reference relays through 32 MB chunks, a limit
    of its host-to-TPU link that a plain copy does not have."""
    moved = 0

    def stage(node):
        nonlocal moved
        if not is_qtensor(node):
            return node
        moved += node.nbytes
        return node.to(device)

    return tree_map(stage, params), moved


def params_nbytes(params) -> int:
    """Total stored bytes of a params tree (QTensor-aware)."""
    total = 0
    for leaf in tree_leaves(params):
        if is_qtensor(leaf):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
    return total
