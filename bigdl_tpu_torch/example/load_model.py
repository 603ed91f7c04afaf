"""Model-validator example (port of ``bigdl_tpu/example/load_model.py``,
plus ``--device``; ref example/loadmodel/ModelValidator.scala: load a
native / Torch .t7 / Caffe model and evaluate Top1+Top5 on an image
dataset).

    python -m bigdl_tpu_torch.example.load_model --modelType bigdl \
        --model lenet.bin -f ./mnist --dataset mnist
    python -m bigdl_tpu_torch.example.load_model --modelType caffe \
        --caffeDefPath deploy.prototxt --model net.caffemodel \
        --modelFactory lenet -f ./mnist
    python -m bigdl_tpu_torch.example.load_model --modelType bigdl \
        --model resnet50.bin -f ./shards --dataset imagenet

``--dataset imagenet`` evaluates over a folder of record shards or
``.seq`` files: its "val" files, or all of them when none is named so.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Load + validate a model")
    p.add_argument("--modelType", required=True,
                   choices=["bigdl", "torch", "caffe"])
    p.add_argument("--model", required=True,
                   help="model file (.bin / .t7 / .caffemodel)")
    p.add_argument("--caffeDefPath", default=None, help="prototxt (caffe)")
    p.add_argument("--modelFactory", default=None,
                   help="factory to build the skeleton for caffe weight "
                        "copy: lenet|alexnet|inception_v1|vgg16|resnet50")
    p.add_argument("-f", "--folder", required=True, help="data dir")
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "imagenet"])
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _build_skeleton(name: str, device):
    from bigdl_tpu_torch.models import (AlexNet, Inception_v1, LeNet5,
                                        ResNet, Vgg_16)

    factories = {
        "lenet": lambda: LeNet5(10),
        "alexnet": lambda: AlexNet(1000),
        "inception_v1": lambda: Inception_v1(1000),
        "vgg16": lambda: Vgg_16(1000),
        "resnet50": lambda: ResNet(1000, depth=50, dataset="imagenet"),
    }
    if name not in factories:
        raise SystemExit(f"--modelFactory must be one of {sorted(factories)}")
    return factories[name]().build(seed=1, device=device)


def load_model(args):
    from bigdl_tpu_torch import nn

    if args.modelType == "bigdl":
        return nn.Module.load(args.model, device=args.device)
    if args.modelType == "torch":
        return nn.Module.load_torch(args.model, device=args.device)
    if not args.caffeDefPath or not args.modelFactory:
        raise SystemExit("caffe loading needs --caffeDefPath and --modelFactory")
    model = _build_skeleton(args.modelFactory, args.device)
    return model.load_caffe(args.caffeDefPath, args.model)


def _dataset(args):
    from bigdl_tpu_torch.dataset import DataSet, image

    if args.dataset == "mnist":
        from bigdl_tpu_torch.dataset import mnist
        records = mnist.load(args.folder, train=False)
        return DataSet.array(records) >> (
            image.BytesToGreyImg(28, 28)
            >> image.GreyImgNormalizer(mnist.TEST_MEAN, mnist.TEST_STD)
            >> image.GreyImgToBatch(args.batchSize))
    if args.dataset == "cifar10":
        from bigdl_tpu_torch.dataset import cifar
        records = cifar.load(args.folder, train=False)
        return DataSet.array(records) >> (
            image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.BGRImgToBatch(args.batchSize))
    from bigdl_tpu_torch.models.utils import (imagenet_shards,
                                              imagenet_val_pipe)
    return DataSet.record_files(
        imagenet_shards(args.folder, val_fallback="all")[1]) \
        >> imagenet_val_pipe(args.batchSize)


def main(argv=None):
    """Load and validate; prints ``<method> is <result>`` per method and
    returns the (method, result) pairs."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy, Top5Accuracy

    Engine.init()
    model = load_model(args)
    ds = _dataset(args)
    results = LocalValidator(model, ds).test([Top1Accuracy(), Top5Accuracy()])
    for method, result in results:
        print(f"{method} is {result}")
    return results


if __name__ == "__main__":
    main()
