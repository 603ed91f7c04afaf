"""LeNet-5 MNIST training CLI (port of ``bigdl_tpu/models/lenet/train.py``:
the same flags and defaults, plus ``--device``).

    python -m bigdl_tpu_torch.models.lenet.train -f /path/to/mnist -b 128 -e 10
    python -m bigdl_tpu_torch.models.lenet.train --synthetic --device cpu
    python -m bigdl_tpu_torch.models.lenet.train --synthetic \
        --checkpoint ckpt -e 1      # then: --resume ckpt -e 2

``--checkpoint`` checkpoints every epoch and stops with a checkpoint on
SIGTERM; ``--resume`` continues from the directory's newest pair (either
package's).  ``--distributed`` is refused (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train LeNet-5 on MNIST")
    p.add_argument("-f", "--folder", default="./", help="MNIST data dir")
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="state snapshot to resume")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir: resume from its newest model/state "
                        "pair")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-e", "--maxEpoch", type=int, default=10)
    p.add_argument("-r", "--learningRate", type=float, default=0.05)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic data (no MNIST files needed)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    """Train; returns the optimizer (its ``state`` holds the last loss,
    ``validation_results`` the last validation)."""
    args = build_parser().parse_args(argv)
    from bigdl_tpu_torch.models.utils import (refuse_distributed,
                                              resolve_resume,
                                              restore_optim_state)
    refuse_distributed(args)
    resolve_resume(args)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, image, mnist
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

    if args.synthetic:
        train_records = mnist.synthetic(4096)
        test_records = mnist.synthetic(512, seed=9)
        mean, std = 60.0, 80.0
    else:
        train_records = mnist.load(args.folder, train=True)
        test_records = mnist.load(args.folder, train=False)
        mean, std = mnist.TRAIN_MEAN, mnist.TRAIN_STD
    pipeline = (image.BytesToGreyImg(28, 28)
                >> image.GreyImgNormalizer(mean, std)
                >> image.GreyImgToBatch(args.batchSize))
    train_ds = DataSet.array(train_records) >> pipeline
    val_ds = DataSet.array(test_records) >> pipeline

    if args.model:
        model = nn.Module.load(args.model, device=args.device)
    else:
        model = LeNet5(10).build(seed=1, device=args.device)
    optimizer = Optimizer.create(model, train_ds, nn.ClassNLLCriterion())
    method = SGD(learning_rate=args.learningRate)
    if args.state:
        restore_optim_state(optimizer, method, args.state)
    optimizer.set_optim_method(method) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch)) \
             .set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        # SIGTERM: a final checkpoint and a clean return; --resume goes on
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
