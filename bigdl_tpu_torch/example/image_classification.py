"""Image-classification predictor example (port of
``bigdl_tpu/example/image_classification.py``, plus ``--device``; ref
example/imageclassification/ImagePredictor.scala: broadcast a trained
model and map batched forwards over an image DataFrame via
DLClassifier).

    python -m bigdl_tpu_torch.example.image_classification \
        --model lenet.bin --folder ./images --modelType lenet

Prints ``<path>: <top-N 1-based classes>`` per image.
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict classes for an image folder")
    p.add_argument("--model", required=True, help="trained model file")
    p.add_argument("-f", "--folder", required=True,
                   help="image dir: <folder>/<class>/<img> or flat files")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--modelType", default="imagenet",
                   choices=["imagenet", "lenet", "cifar10"],
                   help="selects the preprocessing pipeline")
    p.add_argument("--topN", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _pipeline(model_type: str):
    from bigdl_tpu_torch.dataset import image

    if model_type == "lenet":
        from bigdl_tpu_torch.dataset import mnist
        return (image.LocalImgReader(scale_to=28) >> image.GreyFromBGR()
                >> image.GreyImgCropper(28, 28)
                >> image.GreyImgNormalizer(mnist.TRAIN_MEAN,
                                           mnist.TRAIN_STD)), (1, 28, 28)
    if model_type == "cifar10":
        from bigdl_tpu_torch.dataset import cifar
        return (image.LocalImgReader(scale_to=32)
                >> image.BGRImgCropper(32, 32)
                >> image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)), (3, 32, 32)
    return (image.LocalImgReader(scale_to=256)
            >> image.BGRImgCropper(224, 224)
            >> image.BGRImgNormalizer((104.0, 117.0, 123.0), (1.0, 1.0, 1.0))), (3, 224, 224)


#: the file names the folder scan takes for images
IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm")


def folder_records(root: str) -> list:
    """(path, label) records of ``<root>/<class>/<img>`` (labels 1-based
    by sorted class directory) or of a flat image directory (label 0)."""
    import os

    def is_image(name: str) -> bool:
        return name.lower().endswith(IMG_EXTS)

    entries = sorted(os.listdir(root))
    if any(os.path.isdir(os.path.join(root, e)) for e in entries):
        records = []
        for li, cls in enumerate(
                (e for e in entries if os.path.isdir(os.path.join(root, e))),
                start=1):
            d = os.path.join(root, cls)
            records.extend((os.path.join(d, f), float(li))
                           for f in sorted(os.listdir(d)) if is_image(f))
        return records
    return [(os.path.join(root, f), 0.0) for f in entries if is_image(f)]


def main(argv=None):
    """Predict; prints one line per image and returns (path, classes)
    pairs."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np

    from bigdl_tpu_torch import Engine, nn
    from bigdl_tpu_torch.ml import DLClassifier

    Engine.init()
    records = folder_records(args.folder)
    if not records:
        raise SystemExit(f"no image files found under {args.folder}")

    pipe, feat_shape = _pipeline(args.modelType)
    images = list(pipe(iter(records)))
    feats = np.stack([img.data for img in images])

    model = nn.Module.load(args.model, device=args.device)
    clf = DLClassifier(model, (args.batchSize, *feat_shape))
    out = clf.predict(feats)
    top = np.argsort(-out, axis=-1)[:, :args.topN] + 1  # 1-based classes
    lines = []
    for (path, _), classes in zip(records, top):
        print(f"{path}: {' '.join(str(int(c)) for c in classes)}")
        lines.append((path, [int(c) for c in classes]))
    return lines


if __name__ == "__main__":
    main()
