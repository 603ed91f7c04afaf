"""Recurrent stack (port of ``bigdl_tpu/nn/recurrent.py``; ref
nn/Recurrent.scala, Cell.scala, RNN.scala, LSTM.scala, GRU.scala,
BiRecurrent.scala, TimeDistributed.scala).

The reference unrolls a cell with ``lax.scan``; here ``Recurrent`` loops
over time in Python and autograd records every step.  The layout and
the trees are the reference's: input (batch, time, feature), weights
``w_ih`` (in, k*H) and ``w_hh`` (H, k*H) with the gates fused in the
order i, f, g, o (LSTM) and r, z, n (GRU), one bias (k*H,), all drawn
through the key chain so that ``build(seed)`` is the reference's tree
bit for bit.

A step is eager PyTorch: the input's part of every step, ``x @ w_ih +
bias``, is one product over all T before the loop (the same function:
the reference computes it inside each step), and each step adds the
state's product with ``torch.addmm``, then the gates' elementwise math.
Gate dropout (``p > 0``, training, a key) keeps the reference's masks:
``split(rng, T)`` keys, one Bernoulli draw per step of the gates'
shape, drawn on the host for all T and copied in one transfer.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn._util import match_compute_dtype
from bigdl_tpu_torch.nn.activations import Tanh
from bigdl_tpu_torch.nn.dropout import keep_mask, keep_masks
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.table_ops import CAddTable
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.pytree import tree_leaves


def _uniform(rng, shape, stdv):
    return keychain.uniform(rng, shape, -stdv, stdv)


class Cell(Module):
    """Base recurrent cell (ref nn/Cell.scala).  A subclass defines
    ``init``, ``init_state``, ``project`` (the input's part of the gates,
    bias included, for any leading shape) and ``recur`` (one step from
    the projected input); ``step`` is the two together, as the
    reference's ``step``."""

    hidden_size: int
    n_gates: int = 1

    def init_state(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def project(self, params, x):
        x = match_compute_dtype(x, params["w_ih"])
        return torch.matmul(x, params["w_ih"]) + params["bias"]

    def recur(self, params, xw_t, state, keep=None):
        """(params, projected (B, k*H), state, dropout mask or None) ->
        (output (B, H), new_state)."""
        raise NotImplementedError

    def step(self, params, x_t, state, *, training=False, rng=None):
        """(params, (B, in), state) -> (output (B, H), new_state); with
        ``training``, ``p > 0`` and a key, the gates' dropout mask is
        drawn from ``rng`` itself."""
        keep = None
        if training and getattr(self, "p", 0.0) > 0.0 and rng is not None:
            keep = keep_mask(rng, (x_t.shape[0],
                                   self.n_gates * self.hidden_size),
                             1.0 - self.p, x_t.device)
        return self.recur(params, self.project(params, x_t), state, keep)

    def _gate_dropout(self, gates, keep):
        """Dropout on the gate pre-activations (the reference applies
        Dropout(p) on each gate input path, nn/LSTM.scala)."""
        if keep is None:
            return gates
        return torch.where(keep, gates / (1.0 - self.p),
                           torch.zeros((), dtype=gates.dtype,
                                       device=gates.device))

    # a Cell used alone maps one input from the zero state, as BigDL's
    # does; the common path is through Recurrent
    def f(self, params, x, *, training=False, rng=None, **kw):
        y, _ = self.step(params, x,
                         self.init_state(x.shape[0], x.dtype, x.device),
                         training=training, rng=rng)
        return y


class RnnCell(Cell):
    """Elman cell: h' = act(W x + U h + b) (ref nn/RNN.scala)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Optional[Module] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation if activation is not None else Tanh()

    def init(self, rng):
        k = keychain.split(rng, 4)  # the fourth key is unused, as there
        stdv = 1.0 / math.sqrt(self.hidden_size)
        return {"w_ih": _uniform(k[0], (self.input_size, self.hidden_size),
                                 stdv),
                "w_hh": _uniform(k[1], (self.hidden_size, self.hidden_size),
                                 stdv),
                "bias": _uniform(k[2], (self.hidden_size,), stdv)}

    def init_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def recur(self, params, xw_t, h, keep=None):
        h = match_compute_dtype(h, params["w_hh"])
        h_new = self.activation.f({}, torch.addmm(xw_t, h, params["w_hh"]))
        return h_new, h_new


class LSTM(Cell):
    """LSTM cell with the four gates fused in one product (ref
    nn/LSTM.scala).  ``p`` is dropout on the gate pre-activations (0
    disables it, the reference's default)."""

    n_gates = 4

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p

    def init(self, rng):
        k = keychain.split(rng, 3)
        stdv = 1.0 / math.sqrt(self.hidden_size)
        H = self.hidden_size
        return {"w_ih": _uniform(k[0], (self.input_size, 4 * H), stdv),
                "w_hh": _uniform(k[1], (H, 4 * H), stdv),
                "bias": _uniform(k[2], (4 * H,), stdv)}

    def init_state(self, batch, dtype=torch.float32, device=None):
        H = self.hidden_size
        return (torch.zeros((batch, H), dtype=dtype, device=device),
                torch.zeros((batch, H), dtype=dtype, device=device))

    def recur(self, params, xw_t, state, keep=None):
        h, c = state
        h = match_compute_dtype(h, params["w_hh"])
        gates = self._gate_dropout(torch.addmm(xw_t, h, params["w_hh"]),
                                   keep)
        # chunk, not slices: the backward is one cat of the four gates'
        # gradients, where each slice's would fill and copy a full one
        i, f, g, o = gates.chunk(4, 1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c_new = torch.addcmul(f * c, i, g)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRU(Cell):
    """GRU cell with the three gates fused (ref nn/GRU.scala): r and z
    from the input and the state, n = tanh(xi_n + r * hh_n), the one
    bias on the input's side."""

    n_gates = 3

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p

    def init(self, rng):
        k = keychain.split(rng, 3)
        stdv = 1.0 / math.sqrt(self.hidden_size)
        H = self.hidden_size
        return {"w_ih": _uniform(k[0], (self.input_size, 3 * H), stdv),
                "w_hh": _uniform(k[1], (H, 3 * H), stdv),
                "bias": _uniform(k[2], (3 * H,), stdv)}

    def init_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.hidden_size), dtype=dtype,
                           device=device)

    def recur(self, params, xw_t, h, keep=None):
        H = self.hidden_size
        h = match_compute_dtype(h, params["w_hh"])
        xi_rz, xi_n = self._gate_dropout(xw_t, keep).split([2 * H, H], 1)
        hh_rz, hh_n = torch.matmul(h, params["w_hh"]).split([2 * H, H], 1)
        r, z = torch.sigmoid(xi_rz + hh_rz).chunk(2, 1)
        n = torch.tanh(torch.addcmul(xi_n, r, hh_n))
        h_new = (1 - z) * n + z * h
        return h_new, h_new


class Recurrent(Module):
    """Unroll a cell over the time dim (ref nn/Recurrent.scala): input
    (B, T, F) -> output (B, T, H)."""

    def __init__(self, cell: Optional[Cell] = None):
        super().__init__()
        self.cell = cell
        self.modules = [cell] if cell is not None else []

    def add(self, cell: Cell) -> "Recurrent":
        self.cell = cell
        self.modules = [cell]
        return self

    def init(self, rng):
        return {"cell": self.cell.init(rng)}

    def f(self, params, x, *, training=False, rng=None, **kw):
        B, T = x.shape[0], x.shape[1]
        cell, p_cell = self.cell, params["cell"]
        # the state starts in the dtype of the cell's first float leaf,
        # the dtype its products run in (bf16 under a bf16 compute)
        floats = [l for l in tree_leaves(p_cell) if l.is_floating_point()]
        state = cell.init_state(B, floats[0].dtype if floats else x.dtype,
                                x.device)
        p = getattr(cell, "p", 0.0)
        keeps = None
        if rng is not None and p > 0.0 and training:
            keeps = keep_masks(keychain.split(rng, T),
                               (B, cell.n_gates * cell.hidden_size),
                               1.0 - p, x.device)
        # the input's part of every step in one product, time-major; the
        # steps take it by unbind, whose backward is one stack (indexing
        # each step would give each a zero-filled gradient of all T)
        xw = cell.project(p_cell, x).transpose(0, 1).contiguous()
        ys = []
        for t, xw_t in enumerate(xw.unbind(0)):
            y, state = cell.recur(p_cell, xw_t, state,
                                  None if keeps is None else keeps[t])
            ys.append(y)
        return torch.stack(ys, dim=1)


class BiRecurrent(Module):
    """Bidirectional recurrence; merges the forward and backward outputs
    with ``merge`` (default elementwise add, ref nn/BiRecurrent.scala).
    As in the reference, neither direction is given ``training`` or a
    key, so gate dropout never runs inside a BiRecurrent."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Optional[Cell] = None,
                 merge: Optional[Module] = None):
        super().__init__()
        self.fwd = Recurrent(cell_fwd)
        self.bwd = Recurrent(cell_bwd if cell_bwd is not None
                             else copy.deepcopy(cell_fwd))
        self.merge = merge if merge is not None else CAddTable()
        self.modules = [self.fwd, self.bwd]

    def init(self, rng):
        k1, k2 = keychain.split(rng)
        return {"fwd": self.fwd.init(k1), "bwd": self.bwd.init(k2)}

    def f(self, params, x, **kw):
        y_f = self.fwd.f(params["fwd"], x)
        y_b = torch.flip(self.bwd.f(params["bwd"], torch.flip(x, (1,))),
                         (1,))
        return self.merge.f({}, [y_f, y_b])


class TimeDistributed(Module):
    """Apply an inner module at every timestep by folding time into
    batch (ref nn/TimeDistributed.scala): one batched call instead of
    T."""

    def __init__(self, module: Module):
        super().__init__()
        self.module = module
        self.modules = [module]

    def init(self, rng):
        return {"module": self.module.init(rng)}

    def init_buffers(self):
        return {"module": self.module.init_buffers()}

    def apply(self, params, x, *, buffers=None, training=False, rng=None):
        B, T = x.shape[0], x.shape[1]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        y, b = self.module.apply(params["module"], flat,
                                 buffers=(buffers or {}).get("module", {}),
                                 training=training, rng=rng)
        return y.reshape((B, T) + tuple(y.shape[1:])), {"module": b}
