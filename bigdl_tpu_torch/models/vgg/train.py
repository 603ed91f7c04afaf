"""VGG CIFAR-10 training CLI (port of ``bigdl_tpu/models/vgg/train.py``:
the same flags and defaults, plus ``--device``).

    python -m bigdl_tpu_torch.models.vgg.train -f /path/to/cifar -b 128
    python -m bigdl_tpu_torch.models.vgg.train --synthetic --device cpu

``--distributed`` is refused (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train VGG on CIFAR-10")
    p.add_argument("-f", "--folder", default="./", help="CIFAR-10 data dir")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="state snapshot to resume")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir: resume from its newest model/state "
                        "pair")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-e", "--maxEpoch", type=int, default=90)
    p.add_argument("-r", "--learningRate", type=float, default=0.01)
    p.add_argument("--weightDecay", type=float, default=0.0005)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    """Train; returns the optimizer."""
    args = build_parser().parse_args(argv)
    from bigdl_tpu_torch.models.utils import (cifar_datasets,
                                              refuse_distributed,
                                              resolve_resume,
                                              restore_optim_state)
    refuse_distributed(args)
    resolve_resume(args)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import (SGD, EpochStep, Optimizer,
                                       Top1Accuracy, Trigger)

    train_ds, val_ds = cifar_datasets(args.folder, args.batchSize,
                                      args.synthetic)
    model = (nn.Module.load(args.model, device=args.device) if args.model
             else VggForCifar10(10).build(seed=1, device=args.device))
    # the reference's schedule: half the rate every 25 epochs
    method = SGD(learning_rate=args.learningRate,
                 weight_decay=args.weightDecay, momentum=args.momentum,
                 dampening=0.0, learning_rate_schedule=EpochStep(25, 0.5))
    optimizer = Optimizer.create(model, train_ds, nn.ClassNLLCriterion())
    if args.state:
        restore_optim_state(optimizer, method, args.state)
    optimizer.set_optim_method(method) \
             .set_end_when(Trigger.max_epoch(args.maxEpoch)) \
             .set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
