"""Text-classifier evaluation CLI (port of
``bigdl_tpu/models/textclassifier/test.py``: load a trained model and
report its Top1 accuracy), plus ``--device``.

    python -m bigdl_tpu_torch.models.textclassifier.test --model m.bin -f /data
    python -m bigdl_tpu_torch.models.textclassifier.test --model m.bin \
        --synthetic --device cpu
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Evaluate; prints ``Top1Accuracy is ...`` and returns the (method,
    result) pairs."""
    p = argparse.ArgumentParser(description="Evaluate the text classifier")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("-f", "--baseDir", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--seqLength", type=int, default=500)
    p.add_argument("--embedDim", type=int, default=100)
    p.add_argument("--classNum", type=int, default=20)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.textclassifier.train import (
        _synthetic_samples, load_news_samples)
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy

    if args.synthetic:
        class_num = min(args.classNum, 5)
        samples = _synthetic_samples(256, class_num, args.seqLength,
                                     args.embedDim, seed=9)
    else:
        # the same held-out split the train CLI validated on
        _, samples = load_news_samples(args.baseDir, args.seqLength,
                                       args.embedDim)
    ds = DataSet.array(samples) >> SampleToBatch(args.batchSize)
    model = nn.Module.load(args.model, device=args.device)
    results = LocalValidator(model, ds).test([Top1Accuracy()])
    for method, result in results:
        print(f"{method} is {result}")
    return results


if __name__ == "__main__":
    main()
