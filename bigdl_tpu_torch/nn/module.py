"""Module system (port of ``bigdl_tpu/nn/module.py``): Torch-style modules
over pure functions of a parameter tree.

Rebuild of the reference's ``nn/abstractnn/AbstractModule.scala:40-311``
and ``AbstractCriterion.scala:29-55``.  As in the JAX package each module
is split into

- hyperparameters: plain attributes fixed at construction;
- ``init(rng) -> params``: a nested dict of float32 numpy arrays drawn
  from a key of the key chain (:mod:`bigdl_tpu_torch.utils.keychain`,
  ``jax.random`` bit for bit), so the same seed gives the reference's
  tree;
- ``init_buffers() -> buffers``: non-trainable state, usually ``{}``;
- ``apply(params, x, buffers=..., training=..., rng=...) -> (y,
  buffers')``: the forward over tensors, with ``f`` the stateless body.

On top sits the Torch-style object shell: ``build`` draws the tree in
numpy and moves it to the device (the card unless the caller names the
CPU); ``forward``/``backward`` mirror ``updateOutput`` and
``updateGradInput`` + ``accGradParameters``, the backward a
``torch.autograd`` pullback over (params, input) as the reference's is a
``jax.vjp``.  Training loops use the functional path.

The classes do not derive from ``torch.nn.Module``: its
``parameters()``, ``buffers()``, ``apply(fn)``, ``modules()``,
``train()`` and ``training`` collide with this API (``buffers`` is a
dict here, ``Container.modules`` a list, ``apply(params, x)`` the
forward, ``training()`` a mode switch and ``train`` its flag).  A module
is a plain object holding dicts of tensors, as ``TransformerLM`` and
``MultiHeadAttention`` already are.

``Activity`` (Tensor or Table) needs no class: any nested tensor, Table,
tuple or dict is one (:mod:`bigdl_tpu_torch.utils.pytree`).
"""
from __future__ import annotations

import copy
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain, pytree
from bigdl_tpu_torch.utils.params import params_from_numpy
from bigdl_tpu_torch.utils.table import T

Params = Any
Buffers = Any
Activity = Any


def _is_array_like(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _as_key(seed) -> np.ndarray:
    if isinstance(seed, (int, np.integer)):
        return keychain.prng_key(int(seed))
    return np.asarray(seed).astype(np.uint32)


def to_device(x, device):
    """An activity's array leaves as tensors on ``device``: numpy
    float64 becomes float32, as JAX (64-bit off) reads it; other leaves
    pass through."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, np.ndarray):
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return a
    return pytree.tree_map(put, x)


def _tree_add(a, b):
    return pytree.tree_map(torch.add, a, b)


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 12)")


class Module:
    """Base module (ref AbstractModule).  Subclasses implement ``init``
    and either ``f`` (stateless: params, x -> y) or ``apply``
    (stateful)."""

    def __init__(self):
        self._name: Optional[str] = None
        # OO shell state (not used by the functional path)
        self.params: Params = None
        self.buffers: Buffers = {}
        self.grad_params: Params = None
        self.output: Activity = None
        self.grad_input: Activity = None
        self.train: bool = True
        self.forward_time: float = 0.0
        self.backward_time: float = 0.0
        self._rng = None
        self._batch_buckets: Optional[tuple] = None
        self.device: Optional[torch.device] = None

    # ------------------------------------------------------------------ #
    # functional core                                                    #
    # ------------------------------------------------------------------ #
    def init(self, rng) -> Params:
        """Create trainable parameters (numpy) from a key. Default: none."""
        return {}

    def init_buffers(self) -> Buffers:
        return {}

    def f(self, params: Params, x: Activity, *, training: bool = False,
          rng=None) -> Activity:
        raise NotImplementedError(
            f"{type(self).__name__} must implement f() or apply()")

    def apply(self, params: Params, x: Activity, *, buffers: Buffers = None,
              training: bool = False, rng=None):
        """The forward over tensors. Returns (output, new_buffers)."""
        y = self.f(params, x, training=training, rng=rng)
        return y, (buffers if buffers is not None else {})

    # ------------------------------------------------------------------ #
    # parameter bookkeeping                                              #
    # ------------------------------------------------------------------ #
    def has_params(self) -> bool:
        tree = (self.init(keychain.prng_key(0)) if self.params is None
                else self.params)
        return len(pytree.tree_leaves(tree)) > 0

    def set_name(self, name: str) -> "Module":
        self._name = name
        return self

    def get_name(self) -> str:
        return self._name or type(self).__name__

    # ------------------------------------------------------------------ #
    # Torch-style OO shell                                               #
    # ------------------------------------------------------------------ #
    def build(self, seed=0, device=None) -> "Module":
        """Materialize params and buffers: the reference's key chain
        (``prng_key(seed)``, ``split``, ``init``) in numpy, then moved to
        ``device`` (default the card)."""
        init_rng, self._rng = keychain.split(_as_key(seed))
        self.device = resolve_device(device)
        self.params = params_from_numpy(self.init(init_rng), self.device)
        self.buffers = params_from_numpy(self.init_buffers(), self.device)
        self.zero_grad_parameters()
        return self

    def load_numpy_tree(self, params, buffers=None,
                        device=None) -> "Module":
        """Take a parameter tree and buffers held as numpy arrays (a JAX
        package module's ``params``/``buffers`` through ``np.asarray``
        leaf by leaf, or a file's) into this module, on ``device`` (the
        module's own, else the card).  The keys and shapes must be this
        architecture's: the reference's trees cross over unchanged (OIHW
        convolution weights, (out, in) linear weights, BN's running
        statistics as buffers)."""
        from bigdl_tpu_torch.utils.file_io import _check_tree, _param_shapes
        _check_tree(params, _param_shapes(self))
        if device is not None or self.device is None:
            self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device)
        self.buffers = params_from_numpy(
            buffers if buffers is not None else self.init_buffers(),
            self.device)
        self.zero_grad_parameters()
        return self

    def reset(self, seed=0, device=None) -> "Module":
        return self.build(seed, device)

    def _built(self):
        if self.params is None:
            self.build()
        return self.params

    def _device(self) -> torch.device:
        if self.device is None:
            for leaf in pytree.tree_leaves(self.params):
                if isinstance(leaf, torch.Tensor):
                    self.device = leaf.device
                    break
            else:
                self.device = resolve_device(None)
        return self.device

    def _next_rng(self):
        if self._rng is None:
            self._rng = keychain.prng_key(0)
        self._rng, sub = keychain.split(self._rng)
        return sub

    def register_batch_buckets(self, buckets: Sequence[int]) -> "Module":
        """Pad eval-mode ``forward`` batches up to these leading-dim
        buckets, so every batch size within a bucket runs one shape.
        Inference only: the training path never pads.  Pass None to
        unregister.  ``serving.ServingEngine`` is the batched-traffic
        version of the same idea."""
        self._batch_buckets = (tuple(sorted(set(int(b) for b in buckets)))
                               if buckets is not None else None)
        if self._batch_buckets and self._batch_buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        return self

    def _bucket_batch(self, x) -> Optional[int]:
        """The bucket to pad ``x``'s leading dim to, or None for the
        exact-shape path (training mode, no buckets registered, non-
        array input, or batch larger than the largest bucket)."""
        buckets = self._batch_buckets
        if self.train or not buckets or not _is_array_like(x) \
                or x.ndim < 1:
            return None
        n = int(x.shape[0])
        for b in buckets:
            if b >= n:
                return b if b != n else None  # exact hit: no pad needed
        return None

    def _run(self, params, x, training: bool, rng):
        # quantized params: expand the non-native QTensors at the entry
        # (identity for float trees; see quant.transform.dequantize_entry)
        from bigdl_tpu_torch.quant.transform import dequantize_entry
        return self.apply(dequantize_entry(params), x, buffers=self.buffers,
                          training=training, rng=rng)

    def forward(self, x: Activity) -> Activity:
        """Stateful forward (ref AbstractModule.forward:144-150, with
        timing); no autograd graph is kept."""
        self._built()
        t0 = time.perf_counter()
        rng = self._next_rng()
        x = to_device(x, self._device())
        bucket = self._bucket_batch(x)
        with torch.no_grad():
            if bucket is not None:
                n = int(x.shape[0])
                pad = x.new_zeros((bucket - n,) + tuple(x.shape[1:]))
                y, _ = self._run(self.params, torch.cat([x, pad]),
                                 self.train, rng)
                y = pytree.tree_map(
                    lambda a: a[:n] if (isinstance(a, torch.Tensor)
                                        and a.ndim >= 1
                                        and a.shape[0] == bucket) else a, y)
            else:
                y, new_buffers = self._run(self.params, x, self.train, rng)
                if self.train:
                    self.buffers = new_buffers
        self.output = y
        self.forward_time += time.perf_counter() - t0
        return y

    def update_output(self, x: Activity) -> Activity:
        return self.forward(x)

    def _pullback(self, x, grad_output, rng, *, want_params: bool,
                  want_input: bool):
        """One forward under autograd and its pullback of
        ``grad_output``: ``(param grads, input grads)``, each a tree of
        the params' or the input's shape (None where not asked for).  A
        leaf the output does not depend on gets zeros, as ``jax.vjp``
        gives; so does an integer input."""
        dev = self._device()
        x = to_device(x, dev)
        g = to_device(grad_output, dev)
        p_leaves, p_def = pytree.tree_flatten(self.params)
        x_leaves, x_def = pytree.tree_flatten(x)

        def track(leaves, want):
            return [l.detach().requires_grad_(want and l.is_floating_point())
                    if isinstance(l, torch.Tensor) else l for l in leaves]

        p_req = track(p_leaves, want_params)
        x_req = track(x_leaves, want_input)
        with torch.enable_grad():
            y, _ = self.apply(pytree.tree_unflatten(p_def, p_req),
                              pytree.tree_unflatten(x_def, x_req),
                              buffers=self.buffers, training=self.train,
                              rng=rng)
            pairs = [(yl, gl) for yl, gl in zip(pytree.tree_leaves(y),
                                                pytree.tree_leaves(g))
                     if isinstance(yl, torch.Tensor) and yl.requires_grad]
            wrt = [t for t in p_req + x_req
                   if isinstance(t, torch.Tensor) and t.requires_grad]
            grads = (torch.autograd.grad(
                [yl for yl, _ in pairs], wrt,
                [gl.to(yl.dtype) for yl, gl in pairs], allow_unused=True)
                if pairs and wrt else [None] * len(wrt))
        by_id = dict(zip(map(id, wrt), grads))

        def collect(req, leaves, tdef):
            out = []
            for r, leaf in zip(req, leaves):
                gr = by_id.get(id(r))
                out.append(gr if gr is not None else
                           torch.zeros_like(leaf)
                           if isinstance(leaf, torch.Tensor) else None)
            return pytree.tree_unflatten(tdef, out)

        return (collect(p_req, p_leaves, p_def) if want_params else None,
                collect(x_req, x_leaves, x_def) if want_input else None)

    def _accumulate(self, grad_p) -> None:
        self.grad_params = (grad_p if self.grad_params is None
                            else _tree_add(self.grad_params, grad_p))

    def backward(self, x: Activity, grad_output: Activity) -> Activity:
        """Stateful backward: computes gradInput AND accumulates
        parameter gradients (ref AbstractModule.backward:162-169), one
        autograd pullback over (params, input)."""
        self._built()
        t0 = time.perf_counter()
        grad_p, grad_in = self._pullback(x, grad_output, self._next_rng(),
                                         want_params=True, want_input=True)
        self._accumulate(grad_p)
        self.grad_input = grad_in
        self.backward_time += time.perf_counter() - t0
        return grad_in

    def update_grad_input(self, x: Activity,
                          grad_output: Activity) -> Activity:
        """Gradient w.r.t. input only (no param-grad accumulation)."""
        self._built()
        _, grad_in = self._pullback(x, grad_output, self._next_rng(),
                                    want_params=False, want_input=True)
        self.grad_input = grad_in
        return grad_in

    def acc_grad_parameters(self, x: Activity, grad_output: Activity) -> None:
        self._built()
        grad_p, _ = self._pullback(x, grad_output, self._next_rng(),
                                   want_params=True, want_input=False)
        self._accumulate(grad_p)

    def zero_grad_parameters(self) -> None:
        if self.params is not None:
            self.grad_params = pytree.tree_map(
                lambda a: None if is_qtensor(a) else torch.zeros_like(a),
                self.params)

    def parameters(self):
        """(weights, gradWeights) as parallel leaf lists (ref :227), in
        the reference's leaf order."""
        self._built()
        return (pytree.tree_leaves(self.params),
                pytree.tree_leaves(self.grad_params))

    def get_parameters(self):
        """Every param (and grad) flattened into ONE contiguous vector,
        in ``ravel_pytree``'s order (ref getParameters/Module.flatten,
        nn/Module.scala:41), and the function that unflattens one."""
        self._built()
        leaves, tdef = pytree.tree_flatten(self.params)
        shapes = [tuple(a.shape) for a in leaves]

        def flat(ls):
            if not ls:
                return torch.zeros((0,), device=self._device())
            return torch.cat([a.reshape(-1) for a in ls])

        def unravel(v):
            out, i = [], 0
            for s in shapes:
                n = int(np.prod(s, dtype=np.int64))
                out.append(v[i:i + n].reshape(s))
                i += n
            return pytree.tree_unflatten(tdef, out)

        return flat(leaves), flat(pytree.tree_leaves(self.grad_params)), \
            unravel

    def get_parameters_table(self):
        """name -> {weight, bias, gradWeight, gradBias} (ref :242)."""
        self._built()
        table = T()
        self._collect_param_table(table, self.get_name(), self.params,
                                  self.grad_params)
        return table

    def _collect_param_table(self, table, name, params, grads):
        if isinstance(params, dict) and params:
            entry = T()
            for k, v in params.items():
                if _is_array_like(v):
                    entry[k] = v
                    gv = grads[k] if grads is not None and k in grads \
                        else None
                    entry["grad" + k[0].upper() + k[1:]] = gv
            if len(entry):
                table[name] = entry

    # -- mode/flags ----------------------------------------------------- #
    def training(self) -> "Module":
        self.train = True
        return self

    def evaluate(self) -> "Module":
        self.train = False
        return self

    def is_training(self) -> bool:
        return self.train

    # -- timing (ref :125-135) ------------------------------------------ #
    def get_times(self):
        return [(self, self.forward_time, self.backward_time)]

    def reset_times(self) -> None:
        self.forward_time = 0.0
        self.backward_time = 0.0

    def clear_state(self) -> "Module":
        self.output = None
        self.grad_input = None
        return self

    # -- (de)materialization -------------------------------------------- #
    def clone_module(self) -> "Module":
        """Clone sharing no tensor (ref cloneModule via java ser, :284)."""
        def copy_tree(tree):
            return pytree.tree_map(
                lambda a: a.clone() if isinstance(a, torch.Tensor) else a,
                tree)

        new = copy.copy(self)
        new.params = copy_tree(self.params)
        new.buffers = copy_tree(self.buffers)
        new.grad_params = copy_tree(self.grad_params)
        return new

    def save(self, path: str, overwrite: bool = False) -> "Module":
        """Write the module in the JAX package's format 1 (its spec, and
        its params and buffers as numpy)."""
        from bigdl_tpu_torch.utils import file_io
        file_io.save_module(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str, template: "Optional[Module]" = None,
             device=None) -> "Module":
        """Load a module saved by either package.  With ``template`` (a
        code-constructed instance of the architecture) the arrays go into
        it and the spec's class names are not read; without one the
        spec rebuilds the tree by class name on ``device`` (default the
        card)."""
        from bigdl_tpu_torch.utils import file_io
        return file_io.load_module(path, template=template, device=device)

    def save_torch(self, path: str, overwrite: bool = False) -> "Module":
        """Write a Torch7-readable .t7 (ref AbstractModule.saveTorch);
        the tensors are read back to the host."""
        from bigdl_tpu_torch.utils import torch_file
        torch_file.save_model(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load_torch(path: str, device=None) -> "Module":
        """Load a Torch7 .t7 model (ref Module.loadTorch,
        nn/Module.scala:31), its tensors on ``device`` (default the
        card)."""
        from bigdl_tpu_torch.utils import torch_file
        return torch_file.load_model(path, device=device)

    def load_caffe(self, def_path: str, model_path: str,
                   match_all: bool = True) -> "Module":
        """Copy caffe blobs into this model's same-named modules
        (ref Module.loadCaffe, nn/Module.scala:35-39), on its device."""
        from bigdl_tpu_torch.utils import caffe_loader
        self._built()
        return caffe_loader.load(self, def_path, model_path, match_all)

    def save_pytorch(self, path) -> "Module":
        """Write this model's params/buffers as a ``torch.save``d
        PyTorch-convention state dict (CPU tensors, the reference's keys
        in its order).  The file round-trips through ``load_pytorch``;
        loading it into an actual torch module needs a positional key
        rename plus ``strict=False`` (no ``num_batches_tracked`` is
        written), and recurrent cells export the fused layout, which
        torch RNN modules cannot consume (see
        ``utils/torch_import.export_torch_state_dict``)."""
        from bigdl_tpu_torch.utils import torch_import
        sd = torch_import.export_torch_state_dict(self)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   path)
        return self

    def load_pytorch(self, state_dict_or_path,
                     strict: bool = True) -> "Module":
        """Import a PyTorch state dict (or a ``torch.save``d checkpoint
        path) into this model's tensors, on its device (see
        ``utils/torch_import.py`` for the positional mapping
        contract)."""
        import os
        from bigdl_tpu_torch.utils import torch_import
        self._built()
        if isinstance(state_dict_or_path, (str, bytes, os.PathLike)):
            return torch_import.load_torch_checkpoint(
                self, state_dict_or_path, strict=strict)
        return torch_import.load_torch_state_dict(
            self, state_dict_or_path, strict=strict)

    def serve(self, **kwargs) -> "Any":
        """This built module as a servable endpoint on its own device
        unless ``device=`` names another; see
        :class:`bigdl_tpu_torch.serving.ServingEngine` for the knobs
        (buckets, max_batch_size, max_wait_ms, backpressure)."""
        from bigdl_tpu_torch.serving.engine import ServingEngine
        self._built()
        kwargs.setdefault("device", self._device())
        return ServingEngine(self, **kwargs)

    def quantize(self, dtype: str = "int8", *, policy=None,
                 compute: Optional[str] = None) -> "Module":
        """Weight-only quantized EVAL-MODE clone of this built module
        (``self`` keeps its float params: both can serve side by side,
        the graph cache keys them apart).  ``dtype="int8"``: eligible
        weights become QTensors, a ``Linear``'s weight with its native
        per-output-channel scale; ``compute`` picks the products'
        regime; an explicit ``policy`` wins over it.  ``dtype="bf16"``:
        a plain cast.  Inference only; the report is kept on
        ``clone.quant_report`` and published as the ``quant/*``
        gauges."""
        from bigdl_tpu_torch.quant.transform import (QuantPolicy,
                                                     publish_quant_report,
                                                     quantize_params)
        self._built()
        if policy is None and compute is not None:
            policy = QuantPolicy(dtype, compute=compute)
        report: dict = {}
        new = self.clone_module()
        new.params = quantize_params(self.params, dtype, policy=policy,
                                     module=self, report=report)
        new.grad_params = None  # int8 leaves are not differentiable
        new.quant_report = report
        publish_quant_report(report)
        return new.evaluate()

    def __repr__(self) -> str:
        return f"{type(self).__name__}"


class Criterion:
    """Loss base (ref AbstractCriterion).  Subclasses implement
    ``loss(output, target) -> scalar`` as a differentiable torch
    expression."""

    def __init__(self):
        self.output = None
        self.grad_input: Activity = None

    def loss(self, output: Activity, target: Activity):
        raise NotImplementedError

    def _flat_time_reduction(self) -> Optional[str]:
        """How this loss reduces a batch, IF flattening extra leading
        structure into the batch dim is value-equivalent: "mean" /
        "sum", or None when it is not (e.g. per-call weighted
        normalization).  TimeDistributedCriterion uses this to evaluate
        (B, T, ...) as one (B*T, ...) call."""
        return None

    # functional alias
    def apply(self, output: Activity, target: Activity):
        return self.loss(output, target)

    @staticmethod
    def _tensors(output):
        return pytree.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32))
            if isinstance(a, np.ndarray) else a, output)

    # Torch-style shell
    def forward(self, output: Activity, target: Activity):
        with torch.no_grad():
            self.output = self.loss(self._tensors(output), target)
        return self.output

    def backward(self, output: Activity, target: Activity) -> Activity:
        leaves, tdef = pytree.tree_flatten(self._tensors(output))
        req = [l.detach().requires_grad_(True) for l in leaves]
        with torch.enable_grad():
            total = self.loss(pytree.tree_unflatten(tdef, req), target).sum()
            grads = torch.autograd.grad(total, req, allow_unused=True)
        self.grad_input = pytree.tree_unflatten(
            tdef, [g if g is not None else torch.zeros_like(r)
                   for g, r in zip(grads, req)])
        return self.grad_input

    def update_output(self, output, target):
        return self.forward(output, target)

    def update_grad_input(self, output, target):
        return self.backward(output, target)

    def clone_criterion(self) -> "Criterion":
        return copy.copy(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}"
