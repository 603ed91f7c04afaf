"""Inception-v1/v2 ImageNet training CLI (port of
``bigdl_tpu/models/inception/train.py``, the same flags and defaults plus
``--device``; ref models/inception/Train.scala + Options.scala: a
record-shard folder, the 224x224 crop pipeline, SGD with poly decay).

    python -m bigdl_tpu_torch.models.inception.train -f /path/to/shards --modelName inception_v1
    python -m bigdl_tpu_torch.models.inception.train --synthetic --device cpu

``--distributed`` trains data-parallel with ``DistriOptimizer`` over the
ranks ``torchrun`` starts (one per card), or over a world of one.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train Inception on ImageNet")
    p.add_argument("-f", "--folder", default="./",
                   help="dir of record shards or .seq files")
    p.add_argument("--modelName", default="inception_v1",
                   choices=["inception_v1", "inception_v2"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--state", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir: resume from its newest model/state "
                        "pair")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-i", "--maxIteration", type=int, default=62000)
    p.add_argument("-r", "--learningRate", type=float, default=0.01)
    p.add_argument("--weightDecay", type=float, default=0.0002)
    p.add_argument("--classNumber", type=int, default=1000)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _synthetic_records(n: int, seed: int = 0):
    """PNG-encoded 256x256 ByteRecords, labels 1-10, with a learnable
    color/label correlation (the JAX package's records, byte for
    byte)."""
    import io

    import numpy as np
    from PIL import Image

    from bigdl_tpu_torch.dataset.types import ByteRecord

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        label = i % 10
        img = rng.randint(0, 60, size=(256, 256, 3)).astype(np.uint8)
        img[:, :, label % 3] += np.uint8(120)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        out.append(ByteRecord(buf.getvalue(), float(label) + 1.0))
    return out


def main(argv=None):
    """Train; returns the optimizer."""
    args = build_parser().parse_args(argv)
    from bigdl_tpu_torch.models.utils import (IMAGENET_BGR_MEAN,
                                              IMAGENET_BGR_STD,
                                              imagenet_seq_datasets,
                                              imagenet_val_pipe,
                                              resolve_resume,
                                              restore_optim_state,
                                              start_distributed)
    start_distributed(args)
    resolve_resume(args)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, image
    from bigdl_tpu_torch.dataset.hadoop_seqfile import AnyBytesToBGRImg
    from bigdl_tpu_torch.models.inception import Inception_v1, Inception_v2
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Poly, Top1Accuracy,
                                       Top5Accuracy, Trigger)

    if args.synthetic:
        n = max(args.batchSize * 8, 64)
        class_num = 10
        train_ds = DataSet.array(_synthetic_records(n),
                                 distributed=args.distributed) >> \
            image.MTLabeledBGRImgToBatch(
                224, 224, args.batchSize,
                AnyBytesToBGRImg() >> image.BGRImgRdmCropper(224, 224)
                >> image.HFlip(0.5)
                >> image.BGRImgNormalizer(IMAGENET_BGR_MEAN,
                                          IMAGENET_BGR_STD))
        val_ds = DataSet.array(_synthetic_records(max(n // 4, 32), seed=9)) \
            >> imagenet_val_pipe(args.batchSize)
    else:
        train_ds, val_ds = imagenet_seq_datasets(
            args.folder, args.batchSize, distributed=args.distributed)
        class_num = args.classNumber

    factory = Inception_v1 if args.modelName == "inception_v1" \
        else Inception_v2
    model = (nn.Module.load(args.model, device=args.device) if args.model
             else factory(class_num).build(seed=1, device=args.device))
    # the reference's poly decay to maxIteration
    method = SGD(learning_rate=args.learningRate,
                 weight_decay=args.weightDecay,
                 learning_rate_schedule=Poly(0.5, args.maxIteration))
    optimizer = Optimizer.create(model, train_ds, nn.ClassNLLCriterion())
    if args.state:
        restore_optim_state(optimizer, method, args.state)
    optimizer.set_optim_method(method) \
             .set_end_when(Trigger.max_iteration(args.maxIteration)) \
             .set_validation(Trigger.several_iteration(620), val_ds,
                             [Top1Accuracy(), Top5Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint,
                                 Trigger.several_iteration(620))
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
