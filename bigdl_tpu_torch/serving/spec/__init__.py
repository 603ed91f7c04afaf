"""Draft-verify speculative decoding for the LM slot engine (port of
``bigdl_tpu/serving/spec``).

A drafter (a float ``TransformerLM`` or the zero-model
:class:`NgramDrafter`) proposes k tokens per slot; one verify step
scores all k+1 candidate rows (or a candidate tree's nodes) against the
paged target arenas; the host accepts the matching prefix by replaying
the offline sampling key chain, so greedy and sampled speculative
streams equal offline ``generate()``.

Enable with ``LMServingEngine(model, spec=SpecConfig(k=4, draft=lm))``
or ``SpecConfig(drafter_compute="ngram")``.
"""
from bigdl_tpu_torch.serving.spec.draft import DraftModel, NgramDrafter
from bigdl_tpu_torch.serving.spec.metrics import SpecMetrics
from bigdl_tpu_torch.serving.spec.verify import (SpecConfig, TreeShape,
                                                 accept_row, accept_walk,
                                                 default_tree_shapes,
                                                 draft_pick, pick_token,
                                                 tree_accept_walk)

__all__ = ["DraftModel", "NgramDrafter", "SpecConfig", "SpecMetrics",
           "TreeShape", "accept_row", "accept_walk", "default_tree_shapes",
           "draft_pick", "pick_token", "tree_accept_walk"]
