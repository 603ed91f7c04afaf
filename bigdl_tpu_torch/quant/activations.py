"""Activation quantization for int8 and fp8 products (port of
``bigdl_tpu/quant/activations.py``).

int8 x int8 products need the activation operand quantized too, in one
of two regimes:

- **dynamic per-token** (the default): each token row takes its own
  symmetric scale ``amax / 127`` over the contraction axis, computed in
  the step;
- **static calibrated**: :class:`ActCalibrator` records running absmax
  over sample batches, and the frozen per-site scale rides the weight's
  ``QTensor.act_scale`` (:func:`attach_act_scales`).

fp8 (e4m3) sits behind :func:`fp8_supported`, a device-kind gate: torch
carries ``float8_e4m3fn`` everywhere, but only recent generations (and
no CPU) run fp8 products on their matrix units, so a policy asking for
fp8 elsewhere refuses instead of emulating.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from bigdl_tpu_torch.quant.qtensor import QMAX, _EPS, is_qtensor, true_div

#: device kinds whose matrix units compute fp8 products (the reference's
#: pattern, matched here against the CUDA device's name)
_FP8_KIND_RE = re.compile(r"(v5|v6|v7|trillium|ironwood|h100|h200|b200)",
                          re.IGNORECASE)

FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
#: e4m3's largest normal value
E4M3_MAX = 448.0


def fp8_supported(device=None) -> bool:
    """True when torch has ``float8_e4m3fn`` and the CUDA device
    (``device``, default the current one) is an fp8-capable generation;
    False on the CPU."""
    if FP8_DTYPE is None or not torch.cuda.is_available():
        return False
    if device is not None and torch.device(device).type != "cuda":
        return False
    return bool(_FP8_KIND_RE.search(torch.cuda.get_device_name(device)))


def quantize_per_token(x, *, scale: Optional[float] = None):
    """Symmetric int8 per-token activation quantization: ``x`` (..., K)
    float, one scale per row over the last (contraction) axis, or the
    calibrated static ``scale`` for every row.  Returns ``(q int8 (...,
    K), scale float32 (..., 1))``, bitwise the reference's."""
    xf = x.float()
    if scale is not None:
        s = torch.full(xf.shape[:-1] + (1,), float(scale),
                       dtype=torch.float32, device=xf.device)
    else:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        s = true_div(torch.clamp_min(amax, _EPS), QMAX)
    q = torch.clamp(torch.round(xf / s), -QMAX, QMAX).to(torch.int8)
    return q, s


def quantize_per_token_fp8(x, *, force: bool = False):
    """fp8 (e4m3) per-token activation cast with the layout of
    :func:`quantize_per_token`: each row scaled so its amax lands at
    e4m3's top, then cast.  Gated on :func:`fp8_supported` unless
    ``force``."""
    if FP8_DTYPE is None:
        raise NotImplementedError("this torch build has no float8_e4m3fn")
    if not force and not fp8_supported():
        raise NotImplementedError(
            "fp8 compute is gated on capable device kinds "
            f"({_FP8_KIND_RE.pattern}); this device is not one")
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = true_div(torch.clamp_min(amax, _EPS), E4M3_MAX)
    return (xf / s).to(FP8_DTYPE), s


class ActCalibrator:
    """Record running absmax per call site over sample batches, then
    freeze static activation scales:

        cal = ActCalibrator()
        for batch in sample_batches:
            cal.observe("blocks/attn/wq", batch_activation)
        qparams = attach_act_scales(qparams, cal.scales())

    Observation reads one value back per call: an offline pass, not a
    serving step."""

    def __init__(self):
        self._amax: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def observe(self, site: str, x) -> None:
        amax = float(torch.as_tensor(x).float().abs().max())
        self._amax[site] = max(self._amax.get(site, 0.0), amax)
        self._counts[site] = self._counts.get(site, 0) + 1

    def scales(self) -> Dict[str, float]:
        """site -> frozen static scale (absmax / 127, floored at _EPS)."""
        return {site: max(amax, _EPS) / QMAX
                for site, amax in self._amax.items()}

    def describe(self) -> Dict[str, dict]:
        return {site: {"amax": self._amax[site],
                       "batches": self._counts[site]}
                for site in self._amax}


def attach_act_scales(params, scales: Dict[str, float]):
    """Pin calibrated static activation scales onto QTensor leaves by
    tree path (``/``-joined, the ``quant_report`` key layout).  Paths
    and scales without a match are ignored: a calibration set may cover
    more than one model."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if is_qtensor(node):
            s = scales.get("/".join(path))
            if s is not None:
                return node.with_compute(node.compute, act_scale=float(s))
        return node

    return walk(params, ())
