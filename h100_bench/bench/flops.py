"""The table of peaks, and the operations and bytes the work needs,
counted from shapes.

Counts are what the algorithm needs for these inputs, never what a
kernel happens to do: padding rows, recomputation and rows read twice
are not counted, so a share of a peak can only be understated.  A
product of an (m, k) and a (k, n) matrix is 2mkn operations; a causal
query at position p (0-based) attends to p + 1 keys.
"""
from __future__ import annotations

from typing import Iterable, Tuple

#: published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAKS = {
    "bf16_flops": 989e12,
    "fp8_flops": 1979e12,
    "int8_ops": 1979e12,
    "tf32_flops": 495e12,
    # float32-accurate products on the tensor cores (3 TF32 passes): the
    # rate the float32 cells are held to
    "fp32_tensor_flops": 495e12 / 3,
    # float32 outside the tensor cores, given beside it
    "fp32_cuda_core_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}

#: the peak every float32 share is taken against
FP32_PEAK = PEAKS["fp32_tensor_flops"]
HBM = PEAKS["hbm_bytes_per_s"]


def dense_flops_per_token(s: dict) -> float:
    """The products with the weights of every layer, for one token: the
    four attention projections and the two MLP products."""
    h, f = s["hidden"], s["ffn"]
    return 2.0 * (4 * h * h + 2 * h * f) * s["layers"]


def head_flops(s: dict) -> float:
    """The tied head for one position."""
    return 2.0 * s["hidden"] * s["vocab"]


def attention_flops(s: dict, first: int, last: int) -> float:
    """Causal attention (QK^T and PV) of the queries at positions
    ``first`` .. ``last`` - 1, every layer: 4 h (p + 1) a query."""
    n = last - first
    if n <= 0:
        return 0.0
    keys = (first + 1 + last) * n / 2.0   # sum of p + 1 over the queries
    return 4.0 * s["hidden"] * keys * s["layers"]


def prefill_flops(s: dict, prompt_len: int, prefix_len: int) -> float:
    """A prefill of the prompt's tokens past a cached prefix of
    ``prefix_len``, and the head at its last position."""
    n = prompt_len - prefix_len
    return (dense_flops_per_token(s) * n
            + attention_flops(s, prefix_len, prompt_len) + head_flops(s))


def decode_flops(s: dict, position: int) -> float:
    """One decode token at 0-based ``position`` (its context is
    ``position + 1`` keys), with the head."""
    return (dense_flops_per_token(s)
            + attention_flops(s, position, position + 1) + head_flops(s))


def kv_bytes(s: dict, rows: int, bytes_per_value: int = 4) -> float:
    """The keys and values of ``rows`` cached positions, every layer."""
    return 2.0 * s["layers"] * rows * s["hidden"] * bytes_per_value


def paged_attention_flops(s: dict, position: int) -> float:
    return attention_flops(s, position, position + 1)


def train_flops_per_step(s: dict, batch: int, seq_len: int) -> float:
    """Forward and backward (twice the forward) of a step: every product
    with the weights, causal attention and the head, for every token."""
    fwd = (dense_flops_per_token(s) + head_flops(s)) * batch * seq_len \
        + attention_flops(s, 0, seq_len) * batch
    return 3.0 * fwd


def flash_train_counts(s: dict, batch: int, seq_len: int,
                       bytes_per_value: int = 4) -> Tuple[float, float]:
    """(operations, bytes) the causal attention of a training step needs
    in its three kernels, every layer: the forward's two products
    (QK^T, PV), and the backward's four (dV, dP, dQ, dK), each 2 D a
    causal (query, key) pair; bytes: the forward reads Q, K, V and
    writes O and the row statistics, the backward reads Q, K, V, O, dO
    and the statistics and writes dQ, dK, dV."""
    d, heads, L = s["head_dim"], s["heads"], s["layers"]
    pairs = seq_len * (seq_len + 1) / 2.0
    ops = 6 * 2.0 * d * pairs * batch * heads * L
    rows = batch * heads * seq_len
    values = rows * d * (4 + 8) + rows * 2
    return ops, values * bytes_per_value * L


def roofline_seconds(ops: float, nbytes: float,
                     peak: float = FP32_PEAK) -> Tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_ops, t_bytes = ops / peak, nbytes / HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total
