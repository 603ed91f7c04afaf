"""Autoencoder MNIST evaluation CLI (port of
``bigdl_tpu/models/autoencoder/test.py``: load a trained model and
report its reconstruction loss on the test set), plus ``--device``.

    python -m bigdl_tpu_torch.models.autoencoder.test --model ckpt/model.13 \
        --synthetic --device cpu
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; prints ``Loss is ...`` and returns the (method, result)
    pairs."""
    p = argparse.ArgumentParser(description="Evaluate Autoencoder on MNIST")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=150)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, mnist
    from bigdl_tpu_torch.models.autoencoder.train import image_pipeline
    from bigdl_tpu_torch.optim import LocalValidator, Loss

    records = (mnist.synthetic(512, seed=9) if args.synthetic
               else mnist.load(args.folder, train=False))
    ds = DataSet.array(records) >> image_pipeline(args.batchSize)
    model = nn.Module.load(args.model, device=args.device)
    results = LocalValidator(model, ds).test([Loss(nn.MSECriterion())])
    for method, result in results:
        print(f"{method} is {result}")
    return results


if __name__ == "__main__":
    main()
