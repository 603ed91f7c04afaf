"""Detection utilities (port of ``bigdl_tpu/nn/detection.py``; ref
nn/Nms.scala).

Greedy non-maximum suppression with a static result: a ``max_output``
vector of 1-based indices padded with 0, and the count.  The loop runs
``max_output`` rounds on the boxes' device with no read back to the
host: a round after the last live box writes 0 and adds nothing to the
count.  Each round takes the highest live score (``argmax``: a tie goes
to the lowest index, as ``jnp.argmax``'s does), records it and kills
every box whose IoU with it exceeds the threshold.  The areas and
intersections use the reference's ``+ 1`` pixel convention, and the IoU
is the reference's float32 expression, operation for operation.
"""
from __future__ import annotations

import numpy as np
import torch


def nms(boxes, scores, iou_threshold: float = 0.5, max_output: int = 100):
    """Greedy NMS over boxes (N, 4) as (x1, y1, x2, y2): returns (int32
    1-based indices padded to ``max_output`` with 0, int32 count), both
    on the boxes' device."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    scores = torch.as_tensor(scores, dtype=torch.float32,
                             device=boxes.device)
    dev = boxes.device
    keep = torch.zeros((max_output,), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    n = boxes.shape[0]
    if n == 0:
        return keep, count
    x1, y1, x2, y2 = boxes.unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(max_output):
        live = alive.any()
        # the best box as a (1,) index: indexing by a 0-d tensor would
        # read it back to the host
        best = torch.where(alive, scores, neg_inf).argmax().reshape(1)
        keep[k] = torch.where(live, best[0] + 1, 0).to(torch.int32)
        count = count + live.to(torch.int32)
        bx1, by1, bx2, by2 = boxes.index_select(0, best).unbind(1)
        w = torch.maximum(zero, torch.minimum(bx2, x2)
                          - torch.maximum(bx1, x1) + 1)
        h = torch.maximum(zero, torch.minimum(by2, y2)
                          - torch.maximum(by1, y1) + 1)
        inter = w * h
        iou = inter / (areas.index_select(0, best) + areas - inter)
        alive = (alive & (iou <= iou_threshold)).index_fill(0, best, False)
    return keep, count


class Nms:
    """Object-style wrapper mirroring the reference's Nms class: the
    kept 1-based indices as a numpy array."""

    def __init__(self, iou_threshold: float = 0.5, max_output: int = 100):
        self.iou_threshold = iou_threshold
        self.max_output = max_output

    def __call__(self, boxes, scores):
        keep, count = nms(boxes, scores, self.iou_threshold, self.max_output)
        return np.asarray(keep[:int(count)].cpu())
