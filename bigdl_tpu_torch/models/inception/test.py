"""Inception ImageNet evaluation CLI (port of
``bigdl_tpu/models/inception/test.py`` plus ``--device``; ref
models/inception/Test.scala): Top1 and Top5 of ``--model`` over a
folder's "val" record files (all of them when none is named so)."""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; prints ``<method> is <result>`` per method and returns
    the (method, result) pairs."""
    p = argparse.ArgumentParser(description="Evaluate Inception on ImageNet")
    p.add_argument("-f", "--folder", default="./", help="record shard dir")
    p.add_argument("--model", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.utils import imagenet_shards, imagenet_val_pipe
    from bigdl_tpu_torch.optim import (LocalValidator, Top1Accuracy,
                                       Top5Accuracy)

    if args.synthetic:
        from bigdl_tpu_torch.models.inception.train import _synthetic_records
        ds = DataSet.array(_synthetic_records(128, seed=9))
    else:
        ds = DataSet.record_files(
            imagenet_shards(args.folder, val_fallback="all")[1])
    ds = ds >> imagenet_val_pipe(args.batchSize)
    model = nn.Module.load(args.model, device=args.device)
    results = LocalValidator(model, ds).test([Top1Accuracy(), Top5Accuracy()])
    for method, result in results:
        print(f"{method} is {result}")
    return results


if __name__ == "__main__":
    main()
