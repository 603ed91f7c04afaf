"""VGG CIFAR-10 evaluation CLI (port of ``bigdl_tpu/models/vgg/test.py``,
plus ``--device``)."""
from __future__ import annotations

from bigdl_tpu_torch.models.utils import cifar_test_main


def main(argv=None):
    """Evaluate; prints ``Top1Accuracy is ...`` and returns the
    (method, result) pairs."""
    return cifar_test_main("Evaluate VGG on CIFAR-10", argv)


if __name__ == "__main__":
    main()
