"""ResNet training CLI (port of ``bigdl_tpu/models/resnet/train.py``:
the same flags and defaults, plus ``--device``).

    python -m bigdl_tpu_torch.models.resnet.train -f /path/to/cifar --depth 20
    python -m bigdl_tpu_torch.models.resnet.train --synthetic --device cpu

``--dataset imagenet`` reads SequenceFile shards, whose readers are not
ported yet: it is refused, as ``--distributed`` is (ROADMAP Queue 1 item
12).
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train ResNet on CIFAR-10")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--state", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir: resume from its newest model/state "
                        "pair")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-e", "--nepochs", type=int, default=165)
    p.add_argument("--depth", type=int, default=20,
                   help="6n+2 for cifar10; 18/34/50/101/152 for imagenet")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "imagenet"])
    p.add_argument("--classNumber", type=int, default=1000,
                   help="imagenet mode only")
    p.add_argument("--dataFormat", default="NCHW", choices=["NCHW", "NHWC"],
                   help="activation layout (imagenet mode)")
    p.add_argument("--shortcutType", default="A", choices=["A", "B", "C"])
    p.add_argument("-r", "--learningRate", type=float, default=0.1)
    p.add_argument("--weightDecay", type=float, default=1e-4)
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
                                              refuse_imagenet,
                                              resolve_resume,
                                              restore_optim_state)
    refuse_distributed(args)
    if args.dataset == "imagenet":
        refuse_imagenet()
    resolve_resume(args)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.optim import (SGD, EpochSchedule, Optimizer, Regime,
                                       Top1Accuracy, Trigger)

    train_ds, val_ds = cifar_datasets(args.folder, args.batchSize,
                                      args.synthetic)
    model = (nn.Module.load(args.model, device=args.device) if args.model
             else ResNet(10, depth=args.depth,
                         shortcut_type=args.shortcutType,
                         dataset="cifar10").build(seed=1,
                                                  device=args.device))
    # the reference's cifar regime: lr, lr/10 after epoch 80, /100 after 121
    schedule = EpochSchedule([Regime(1, 80, 1.0), Regime(81, 121, 0.1),
                              Regime(122, 100000, 0.01)])
    method = SGD(learning_rate=args.learningRate,
                 weight_decay=args.weightDecay, momentum=args.momentum,
                 dampening=0.0, nesterov=True,
                 learning_rate_schedule=schedule)
    optimizer = Optimizer.create(model, train_ds, nn.ClassNLLCriterion())
    if args.state:
        restore_optim_state(optimizer, method, args.state)
    optimizer.set_optim_method(method) \
             .set_end_when(Trigger.max_epoch(args.nepochs)) \
             .set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        optimizer.handle_preemption()
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
