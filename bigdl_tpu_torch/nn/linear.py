"""Linear-algebra layers (port of ``bigdl_tpu/nn/linear.py``; ref nn/:
Linear, Bilinear, MM, MV, Cosine, Euclidean, DotProduct,
PairwiseDistance, CosineDistance, LookupTable, and the scalar/affine
family Add/AddConstant/Mul/MulConstant/CMul/CAdd/Scale).

Weight layouts preserve Torch conventions: a Linear weight is
(outputSize, inputSize) and y = x @ W.T + b (ref nn/Linear.scala).  The
products are ``torch.matmul`` (cuBLAS on the card).  ``init`` draws
through the key chain, so a built tree is the reference's bit for bit
(``LookupTable``'s normal draw within 4 ulp).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bigdl_tpu_torch.nn._util import match_compute_dtype
from bigdl_tpu_torch.nn.initialization import Default, InitializationMethod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.quant.qtensor import is_qtensor
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.table import Table


def _pair(x):
    return x.to_seq() if isinstance(x, Table) else list(x)


def _uniform(rng, shape, stdv):
    return keychain.uniform(rng, shape, -stdv, stdv)


def _norm(x, dim=-1, keepdim=False):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


class Linear(Module):
    """Fully connected layer (ref nn/Linear.scala, 218 LoC)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_method: type[InitializationMethod] = Default):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.init_method = init_method

    def init(self, rng):
        wk, bk = keychain.split(rng)
        p = {"weight": self.init_method.weight(
            wk, (self.output_size, self.input_size), fan_in=self.input_size)}
        if self.with_bias:
            p["bias"] = self.init_method.bias(bk, (self.output_size,),
                                              fan_in=self.input_size)
        return p

    def f(self, params, x, **kw):
        w = params["weight"]
        if is_qtensor(w):
            from bigdl_tpu_torch.quant.kernels import qlinear
            return qlinear(x, w, params.get("bias")
                           if self.with_bias else None)
        x = match_compute_dtype(x, w)
        y = torch.matmul(x, w.T)
        if self.with_bias:
            y = y + params["bias"]
        return y


class Bilinear(Module):
    """y_k = x1 @ W_k @ x2 + b_k over a table input {x1, x2}
    (ref nn/Bilinear.scala)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True):
        super().__init__()
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res

    def init(self, rng):
        wk, bk = keychain.split(rng)
        stdv = 1.0 / math.sqrt(self.input_size1)
        p = {"weight": _uniform(wk, (self.output_size, self.input_size1,
                                     self.input_size2), stdv)}
        if self.bias_res:
            p["bias"] = _uniform(bk, (self.output_size,), stdv)
        return p

    def f(self, params, x, **kw):
        x1, x2 = _pair(x)
        y = torch.einsum("bi,kij,bj->bk", x1, params["weight"], x2)
        if self.bias_res:
            y = y + params["bias"]
        return y


class MM(Module):
    """Batch or plain matrix-matrix product of a table {A, B}
    (ref nn/MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a = trans_a
        self.trans_b = trans_b

    def f(self, params, x, **kw):
        a, b = _pair(x)
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Matrix-vector product of a table {M, v} (ref nn/MV.scala)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def f(self, params, x, **kw):
        m, v = _pair(x)
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(Module):
    """Row-wise dot product of a table {x1, x2} (ref nn/DotProduct.scala)."""

    def f(self, params, x, **kw):
        x1, x2 = _pair(x)
        return torch.sum(x1 * x2, dim=-1)


class Cosine(Module):
    """Cosine similarity to each of ``output_size`` learned prototypes
    (ref nn/Cosine.scala)."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size

    def init(self, rng):
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"weight": _uniform(rng, (self.output_size, self.input_size),
                                   stdv)}

    def f(self, params, x, **kw):
        w = params["weight"]
        xn = x / (_norm(x, keepdim=True) + 1e-12)
        wn = w / (_norm(w, keepdim=True) + 1e-12)
        return torch.matmul(xn, wn.T)


class Euclidean(Module):
    """Euclidean distance to each learned prototype (ref nn/Euclidean.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size

    def init(self, rng):
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"weight": _uniform(rng, (self.output_size, self.input_size),
                                   stdv)}

    def f(self, params, x, **kw):
        diff = x[..., None, :] - params["weight"]
        return _norm(diff)


class PairwiseDistance(Module):
    """L-p distance between table elements {x1, x2}
    (ref nn/PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def f(self, params, x, **kw):
        x1, x2 = _pair(x)
        d = torch.abs(x1 - x2)
        return torch.pow(torch.sum(torch.pow(d, self.norm), dim=-1),
                         1.0 / self.norm)


class CosineDistance(Module):
    """Cosine similarity between table elements {x1, x2}
    (ref nn/CosineDistance.scala)."""

    def f(self, params, x, **kw):
        x1, x2 = _pair(x)
        n1, n2 = _norm(x1), _norm(x2)
        return torch.sum(x1 * x2, dim=-1) / torch.clamp_min(n1 * n2, 1e-12)


class LookupTable(Module):
    """Embedding lookup with 1-based indices and optional max-norm
    renormalization (ref nn/LookupTable.scala)."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type

    def init(self, rng):
        return {"weight": keychain.normal(rng, (self.n_index, self.n_output))}

    def f(self, params, x, **kw):
        w = params["weight"]
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=-1,
                                             keepdim=True)
            w = torch.where(norms > self.max_norm,
                            w * (self.max_norm / norms), w)
        idx = x.to(torch.int64) - 1  # 1-based Torch indices
        return w[idx]


# ---------------------------------------------------------------------- #
# scalar / affine family                                                 #
# ---------------------------------------------------------------------- #
class Add(Module):
    """Learnable bias vector added to the input (ref nn/Add.scala)."""

    def __init__(self, input_size: int):
        super().__init__()
        self.input_size = input_size

    def init(self, rng):
        stdv = 1.0 / math.sqrt(self.input_size)
        return {"bias": _uniform(rng, (self.input_size,), stdv)}

    def f(self, params, x, **kw):
        return x + params["bias"]


class AddConstant(Module):
    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def f(self, params, x, **kw):
        return x + self.constant_scalar


class Mul(Module):
    """Single learnable scalar gain (ref nn/Mul.scala)."""

    def init(self, rng):
        return {"weight": keychain.uniform(rng, (1,), -1.0, 1.0)}

    def f(self, params, x, **kw):
        return x * params["weight"][0]


class MulConstant(Module):
    def __init__(self, scalar: float, inplace: bool = False):
        super().__init__()
        self.scalar = scalar

    def f(self, params, x, **kw):
        return x * self.scalar


class CMul(Module):
    """Learnable componentwise gain with broadcastable shape
    (ref nn/CMul.scala)."""

    def __init__(self, size: tuple[int, ...]):
        super().__init__()
        self.size = tuple(size)

    def init(self, rng):
        stdv = 1.0 / math.sqrt(int(np.prod(self.size, dtype=np.int64)))
        return {"weight": _uniform(rng, self.size, stdv)}

    def f(self, params, x, **kw):
        return x * params["weight"]


class CAdd(Module):
    """Learnable componentwise bias with broadcastable shape
    (ref nn/CAdd.scala)."""

    def __init__(self, size: tuple[int, ...]):
        super().__init__()
        self.size = tuple(size)

    def init(self, rng):
        stdv = 1.0 / math.sqrt(int(np.prod(self.size, dtype=np.int64)))
        return {"bias": _uniform(rng, self.size, stdv)}

    def f(self, params, x, **kw):
        return x + params["bias"]


class Scale(Module):
    """CMul then CAdd (ref nn/Scale.scala)."""

    def __init__(self, size: tuple[int, ...]):
        super().__init__()
        self.size = tuple(size)
        self._cmul = CMul(size)
        self._cadd = CAdd(size)

    def init(self, rng):
        k1, k2 = keychain.split(rng)
        return {"cmul": self._cmul.init(k1), "cadd": self._cadd.init(k2)}

    def f(self, params, x, **kw):
        return self._cadd.f(params["cadd"], self._cmul.f(params["cmul"], x))
