"""Recurrent language-model training CLI (port of
``bigdl_tpu/models/rnn/train.py``, ref models/rnn/Train.scala: read
text, build a Dictionary, train a Recurrent cell with
TimeDistributedCriterion(ClassNLL)); the same flags plus ``--device``.

    python -m bigdl_tpu_torch.models.rnn.train -f input.txt --vocabSize 4000
    python -m bigdl_tpu_torch.models.rnn.train --synthetic --device cpu \
        --checkpoint ckpt -e 2    # then: --model ckpt/model.<n>

``--checkpoint`` checkpoints every epoch, writes ``dictionary.json``
beside the checkpoints for the evaluation CLI, and stops with a
checkpoint on SIGTERM; ``--model`` continues from a saved model.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train SimpleRNN language model")
    p.add_argument("-f", "--folder", default=None, help="input text file")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-e", "--maxEpoch", type=int, default=30)
    p.add_argument("-r", "--learningRate", type=float, default=0.1)
    p.add_argument("--vocabSize", type=int, default=4000)
    p.add_argument("--hiddenSize", type=int, default=40)
    p.add_argument("--seqLength", type=int, default=24)
    p.add_argument("--cell", default="rnn", choices=["rnn", "lstm"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def read_corpus(args) -> str:
    """The training text: the synthetic corpus with ``--synthetic`` or
    without ``-f``."""
    from bigdl_tpu_torch.models.utils import SYNTH_CORPUS
    if args.synthetic or not args.folder:
        return SYNTH_CORPUS
    with open(args.folder) as f:
        return f.read()


def main(argv=None):
    """Train; returns the optimizer (its ``state`` holds the last loss,
    ``validation_results`` the last validation)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.rnn import LstmLM, SimpleRNN
    from bigdl_tpu_torch.models.utils import lm_corpus, lm_sample_pipe
    from bigdl_tpu_torch.optim import SGD, Loss, Optimizer, Trigger
    from bigdl_tpu_torch.utils import fs

    token_lists, dictionary = lm_corpus(read_corpus(args), args.vocabSize)
    if args.checkpoint:
        # the evaluation CLI reads this word -> index mapping back
        fs.makedirs(args.checkpoint)
        dictionary.save(fs.join(args.checkpoint, "dictionary.json"))
    vocab = dictionary.vocab_size()
    pipe = lm_sample_pipe(dictionary, args.seqLength, args.batchSize)
    split = int(len(token_lists) * 0.8) or 1
    train_ds = DataSet.array(token_lists[:split]) >> pipe
    val_ds = DataSet.array(token_lists[split:] or token_lists[:1]) >> pipe

    factory = SimpleRNN if args.cell == "rnn" else LstmLM
    model = (nn.Module.load(args.model, device=args.device) if args.model
             else factory(vocab, args.hiddenSize, vocab).build(
                 seed=1, device=args.device))
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True)
    optimizer = Optimizer.create(model, train_ds, criterion)
    optimizer.set_optim_method(SGD(learning_rate=args.learningRate)) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch)) \
             .set_validation(Trigger.every_epoch(), val_ds, [Loss(criterion)])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        # SIGTERM: a final checkpoint and a clean return
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
