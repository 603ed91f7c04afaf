"""Autoencoder MNIST training CLI (port of
``bigdl_tpu/models/autoencoder/train.py``, ref
models/autoencoder/Train.scala: the target is the normalized input,
MSECriterion, Adagrad); the same flags plus ``--device``.

    python -m bigdl_tpu_torch.models.autoencoder.train -f /path/to/mnist
    python -m bigdl_tpu_torch.models.autoencoder.train --synthetic \
        --device cpu --checkpoint ckpt -e 1

``--checkpoint`` checkpoints every epoch and stops with a checkpoint on
SIGTERM.
"""
from __future__ import annotations

import argparse
import logging

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.dataset.types import MiniBatch


class ToAutoencoderBatch(Transformer):
    """MiniBatch(data, labels) -> MiniBatch(data, data flattened per
    row): the reconstruction target is the input itself (ref Train.scala
    toAutoencoderBatch)."""

    def transform_one(self, batch: MiniBatch) -> MiniBatch:
        return MiniBatch(batch.data,
                         batch.data.reshape(batch.data.shape[0], -1))


def image_pipeline(batch_size: int):
    """Bytes -> grey images scaled to [0, 1] (mean 0, std 255, the
    sigmoid's range) -> batches -> autoencoder batches."""
    from bigdl_tpu_torch.dataset import image
    return (image.BytesToGreyImg(28, 28)
            >> image.GreyImgNormalizer(0.0, 255.0)
            >> image.GreyImgToBatch(batch_size)) >> ToAutoencoderBatch()


def main(argv=None):
    """Train; returns the optimizer (its ``state`` holds the last
    loss)."""
    p = argparse.ArgumentParser(description="Train Autoencoder on MNIST")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("-b", "--batchSize", type=int, default=150)
    p.add_argument("-e", "--maxEpoch", type=int, default=10)
    p.add_argument("-r", "--learningRate", type=float, default=0.01)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, mnist
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.optim import Adagrad, Optimizer, Trigger

    records = (mnist.synthetic(2048) if args.synthetic
               else mnist.load(args.folder, train=True))
    train_ds = DataSet.array(records) >> image_pipeline(args.batchSize)
    model = Autoencoder(32).build(seed=1, device=args.device)
    optimizer = Optimizer.create(model, train_ds, nn.MSECriterion())
    optimizer.set_optim_method(Adagrad(learning_rate=args.learningRate)) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch))
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        # SIGTERM: a final checkpoint and a clean return
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
