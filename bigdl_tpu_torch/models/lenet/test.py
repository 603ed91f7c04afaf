"""LeNet-5 MNIST evaluation CLI (port of ``bigdl_tpu/models/lenet/test.py``,
plus ``--device``).

    python -m bigdl_tpu_torch.models.lenet.test --model ckpt/model.32 --synthetic
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; prints ``Top1Accuracy is ...`` and returns the
    (method, result) pairs."""
    p = argparse.ArgumentParser(description="Evaluate LeNet-5 on MNIST")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, image, mnist
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy

    records = (mnist.synthetic(512, seed=9) if args.synthetic
               else mnist.load(args.folder, train=False))
    mean, std = ((60.0, 80.0) if args.synthetic
                 else (mnist.TEST_MEAN, mnist.TEST_STD))
    ds = DataSet.array(records) >> (
        image.BytesToGreyImg(28, 28) >> image.GreyImgNormalizer(mean, std)
        >> image.GreyImgToBatch(args.batchSize))
    model = nn.Module.load(args.model, device=args.device)
    results = LocalValidator(model, ds).test([Top1Accuracy()])
    for method, result in results:
        print(f"{method} is {result}")
    return results


if __name__ == "__main__":
    main()
