"""Text-classifier training CLI (port of
``bigdl_tpu/models/textclassifier/train.py``, ref
example/textclassification/TextClassifier.scala:122-176: 20 Newsgroups,
GloVe embeddings, a CNN or LSTM encoder, Adagrad); the same flags plus
``--device``.

    python -m bigdl_tpu_torch.models.textclassifier.train -f /data/news
    python -m bigdl_tpu_torch.models.textclassifier.train --synthetic \
        --encoder lstm --device cpu

``-f`` names a directory holding a ``20news*`` tree and
``glove.6B/glove.6B.<embedDim>d.txt``; ``--synthetic`` needs no files.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the text classifier")
    p.add_argument("-f", "--baseDir", default="./",
                   help="dir containing 20news-*/ and glove.6B/")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-e", "--maxEpoch", type=int, default=20)
    p.add_argument("-r", "--learningRate", type=float, default=0.01)
    p.add_argument("--seqLength", type=int, default=500)
    p.add_argument("--embedDim", type=int, default=100)
    p.add_argument("--encoder", default="cnn", choices=["cnn", "lstm"])
    p.add_argument("--classNum", type=int, default=20)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def load_glove(path: str, embed_dim: int) -> dict:
    """word -> vector from a glove.6B.<dim>d.txt file."""
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) == embed_dim + 1:
                table[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return table


def _embed_docs(docs, labels, glove, seq_len, embed_dim):
    """Token docs -> Samples of (seq_len, embed_dim) float32 and 1-based
    labels (the reference embeds in the data pipeline, not the
    model)."""
    from bigdl_tpu_torch.dataset.types import Sample

    samples = []
    for tokens, label in zip(docs, labels):
        feat = np.zeros((seq_len, embed_dim), dtype=np.float32)
        for i, tok in enumerate(tokens[:seq_len]):
            vec = glove.get(tok)
            if vec is not None:
                feat[i] = vec
        samples.append(Sample(feat, np.float32(label)))
    return samples


def load_news_samples(base_dir: str, seq_len: int, embed_dim: int):
    """(train_samples, val_samples) from 20news + glove under
    ``base_dir``.  The train and test CLIs share it, so the shuffle
    (seed 42) and the 0.8 split cannot part."""
    from bigdl_tpu_torch.dataset import text

    news_dir = next((os.path.join(base_dir, d)
                     for d in sorted(os.listdir(base_dir))
                     if d.startswith("20news") or d.startswith("20_news")),
                    None)
    glove_path = os.path.join(base_dir, "glove.6B",
                              f"glove.6B.{embed_dim}d.txt")
    if news_dir is None or not os.path.exists(glove_path):
        raise SystemExit(f"expected 20news dir and {glove_path} under "
                         f"{base_dir}")
    glove = load_glove(glove_path, embed_dim)
    tokenizer = text.SentenceTokenizer()
    docs, labels = [], []
    cats = [c for c in sorted(os.listdir(news_dir))
            if os.path.isdir(os.path.join(news_dir, c))]
    for li, cat in enumerate(cats, start=1):
        cat_dir = os.path.join(news_dir, cat)
        for fname in sorted(os.listdir(cat_dir)):
            with open(os.path.join(cat_dir, fname), errors="ignore") as f:
                docs.append(tokenizer.transform_one(f.read()))
            labels.append(float(li))
    order = np.random.RandomState(42).permutation(len(docs))
    docs = [docs[i] for i in order]
    labels = [labels[i] for i in order]
    samples = _embed_docs(docs, labels, glove, seq_len, embed_dim)
    split = int(len(samples) * 0.8)
    return samples[:split], samples[split:]


def _synthetic_samples(n, class_num, seq_len, embed_dim, seed=0):
    """n seeded samples: noise plus a class-correlated channel, the
    reference's values bit for bit."""
    from bigdl_tpu_torch.dataset.types import Sample

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        label = i % class_num
        feat = rng.randn(seq_len, embed_dim).astype(np.float32) * 0.1
        feat[:, label % embed_dim] += 1.0  # class-correlated channel
        out.append(Sample(feat, np.float32(label + 1)))
    return out


def main(argv=None):
    """Train; returns the optimizer (its ``model`` the trained
    classifier, ``validation_results`` the last Top1)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.textclassifier import TextClassifier
    from bigdl_tpu_torch.optim import (Adagrad, Optimizer, Top1Accuracy,
                                       Trigger)

    if args.synthetic:
        class_num = min(args.classNum, 5)
        train_samples = _synthetic_samples(1024, class_num, args.seqLength,
                                           args.embedDim)
        val_samples = _synthetic_samples(256, class_num, args.seqLength,
                                         args.embedDim, seed=9)
    else:
        class_num = args.classNum
        train_samples, val_samples = load_news_samples(
            args.baseDir, args.seqLength, args.embedDim)

    batcher = SampleToBatch(args.batchSize)
    train_ds = DataSet.array(train_samples) >> batcher
    val_ds = DataSet.array(val_samples) >> batcher

    model = TextClassifier(class_num, args.embedDim, args.seqLength,
                           encoder=args.encoder).build(seed=1,
                                                       device=args.device)
    optimizer = Optimizer.create(model, train_ds, nn.ClassNLLCriterion())
    optimizer.set_optim_method(Adagrad(learning_rate=args.learningRate)) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch)) \
             .set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
