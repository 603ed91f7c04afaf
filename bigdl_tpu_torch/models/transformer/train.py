"""Transformer language-model training CLI (port of
``bigdl_tpu/models/transformer/train.py``: the same flags and defaults,
plus ``--device``).

    python -m bigdl_tpu_torch.models.transformer.train --synthetic -e 2
    python -m bigdl_tpu_torch.models.transformer.train --synthetic --device cpu
    python -m bigdl_tpu_torch.models.transformer.train -f input.txt --vocabSize 4000
    python -m bigdl_tpu_torch.models.transformer.train --synthetic \
        --checkpoint ckpt -e 1      # then: --resume ckpt -e 2

On a CUDA device the attention runs through the flash kernels (forward
and both backward kernels) for head widths 64 and 128.  ``--checkpoint``
saves ``dictionary.json`` there, checkpoints every epoch and stops with
a checkpoint on SIGTERM; ``--resume`` continues from the directory's
newest pair (a model and state written by either package).
``--distributed`` trains data-parallel with ``DistriOptimizer`` over the
ranks ``torchrun`` starts (one per card), or over a world of one.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train transformer language model")
    p.add_argument("-f", "--folder", default=None, help="input text file")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--state", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir: auto-load the newest model/state pair")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-e", "--maxEpoch", type=int, default=10)
    p.add_argument("-r", "--learningRate", type=float, default=0.1)
    p.add_argument("--optim", default="sgd", choices=["sgd", "adam", "adamw"])
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--vocabSize", type=int, default=4000)
    p.add_argument("--hiddenSize", type=int, default=64)
    p.add_argument("--nHead", type=int, default=4)
    p.add_argument("--nLayers", type=int, default=2)
    p.add_argument("--seqLength", type=int, default=24)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--posEncoding", default="learned",
                   choices=["learned", "rope"],
                   help="rope = rotary (relative) positions, no learned table")
    p.add_argument("--moeExperts", type=int, default=0,
                   help="swap each block's MLP for a top-1 switch MoE "
                        "with this many experts (0 = dense)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the "
                        "backward (long-sequence memory)")
    p.add_argument("--packed", action="store_true",
                   help="pack documents into dense fixed-length windows "
                        "instead of padding each sentence")
    p.add_argument("--docIsolate", action="store_true",
                   help="with --packed: mask attention across document "
                        "boundaries (segment ids derived from the "
                        "sentence-start markers)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    """Train; returns the optimizer (its ``state`` holds the last loss,
    ``validation_results`` the last validation)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset.text import SENTENCE_START
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.models.utils import (SYNTH_CORPUS, lm_corpus,
                                              lm_dataset, resolve_resume,
                                              restore_optim_state,
                                              start_distributed)
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import (SGD, Adam, AdamW, Loss, Optimizer,
                                       Trigger)
    from bigdl_tpu_torch.utils import fs

    start_distributed(args)
    resolve_resume(args)
    if args.synthetic or not args.folder:
        raw = SYNTH_CORPUS
    else:
        with open(args.folder) as f:
            raw = f.read()

    token_lists, dictionary = lm_corpus(raw, args.vocabSize)
    if args.checkpoint:
        dictionary.save(fs.join(args.checkpoint, "dictionary.json"))
    vocab = dictionary.vocab_size()
    split = int(len(token_lists) * 0.8) or 1
    train_ds = lm_dataset(token_lists[:split], dictionary, args.seqLength,
                          args.batchSize, packed=args.packed,
                          distributed=args.distributed)
    try:
        val_ds = lm_dataset(token_lists[split:] or token_lists[:1],
                            dictionary, args.seqLength, args.batchSize,
                            packed=args.packed)
    except SystemExit as e:
        # a validation split too small for one packed window must not
        # stop an ample train split: train without validation instead
        logging.getLogger("bigdl_tpu_torch").warning(
            "validation split too small for --packed windows (%s); "
            "continuing WITHOUT validation", e)
        val_ds = None

    doc_start_id = None
    if args.docIsolate:
        if not args.packed:
            raise SystemExit("--docIsolate requires --packed (the padded "
                             "pipeline never mixes documents in a window)")
        doc_start_id = dictionary.get_index(SENTENCE_START) + 1  # 1-based
    if args.model:
        model = TransformerLM.load(args.model, device=args.device)
        if args.docIsolate:
            # a resumed or fine-tuned model honours the flag too
            model.doc_start_id = doc_start_id
    else:
        model = TransformerLM(
            vocab, hidden_size=args.hiddenSize, n_head=args.nHead,
            n_layers=args.nLayers, max_len=args.seqLength,
            dropout=args.dropout, remat=args.remat,
            pos_encoding=args.posEncoding, moe_experts=args.moeExperts,
            doc_start_id=doc_start_id, device=args.device).build(seed=1)
    criterion = TimeDistributedCriterion(ClassNLLCriterion(), True)
    method = {"sgd": SGD, "adam": Adam, "adamw": AdamW}[args.optim](
        learning_rate=args.learningRate, weight_decay=args.weightDecay)
    optimizer = Optimizer.create(model, train_ds, criterion)
    if args.state:
        restore_optim_state(optimizer, method, args.state)
    optimizer.set_optim_method(method) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch))
    if val_ds is not None:
        optimizer.set_validation(Trigger.every_epoch(), val_ds,
                                 [Loss(criterion)])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        # SIGTERM: a final checkpoint and a clean return; --resume goes on
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
