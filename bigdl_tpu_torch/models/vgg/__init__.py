"""VGG family (port of ``bigdl_tpu/models/vgg``: VggForCifar10, Vgg_16,
Vgg_19; ref models/vgg/VggForCifar10.scala and the perf harness's
factories).

``data_format="NHWC"`` builds the channels-last variant (NHWC input;
cuDNN's NHWC kernels).  The ImageNet nets transpose back to NCHW just
before the flatten, so the classifier's weight order, and so
checkpoints, are the same in both formats; the NCHW build holds a no-op
Transpose, so both share one parameter tree.
"""
from bigdl_tpu_torch import nn

_TO_NCHW = [(2, 4), (3, 4)]  # 1-based swaps: NHWC -> NCHW


def _conv_bn_relu(n_in: int, n_out: int, df: str) -> list:
    return [
        nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(n_out, eps=1e-3, data_format=df),
        nn.ReLU(True),
    ]


def VggForCifar10(class_num: int = 10, data_format: str = "NCHW") -> nn.Sequential:
    """VGG-16-style net with BN for 3x32x32 CIFAR images
    (ref models/vgg/VggForCifar10.scala)."""
    df = data_format
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    layers: list = []
    for item in cfg:
        if item == "M":
            layers.append(nn.SpatialMaxPooling(2, 2, 2, 2, data_format=df).ceil())
        else:
            layers.extend(_conv_bn_relu(*item, df))
    model = nn.Sequential(*layers)
    # spatial is 1x1 here, so the flatten order is format-independent
    model.add(nn.View(512))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(512, 512))
    model.add(nn.BatchNormalization(512))
    model.add(nn.ReLU(True))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(512, class_num))
    model.add(nn.LogSoftMax())
    return model


def _vgg_plain(cfg: list, class_num: int, df: str) -> nn.Sequential:
    layers: list = []
    n_in = 3
    for item in cfg:
        if item == "M":
            layers.append(nn.SpatialMaxPooling(2, 2, 2, 2, data_format=df))
        else:
            layers.append(nn.SpatialConvolution(n_in, item, 3, 3, 1, 1, 1, 1,
                                                data_format=df))
            layers.append(nn.ReLU(True))
            n_in = item
    model = nn.Sequential(*layers)
    # NHWC: restore NCHW flatten order so fc6 weights match the NCHW build;
    # the NCHW build gets a no-op Transpose so both formats share one
    # param-pytree structure (checkpoints stay interchangeable).
    model.add(nn.Transpose(_TO_NCHW if df == "NHWC" else []))
    model.add(nn.View(512 * 7 * 7))
    model.add(nn.Linear(512 * 7 * 7, 4096))
    model.add(nn.Threshold(0, 1e-6))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, 4096))
    model.add(nn.Threshold(0, 1e-6))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, class_num))
    model.add(nn.LogSoftMax())
    return model


def Vgg_16(class_num: int = 1000, data_format: str = "NCHW") -> nn.Sequential:
    """VGG-16 for 3x224x224 ImageNet (ref models/utils perf harness vgg16)."""
    return _vgg_plain([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512, "M"], class_num,
                      data_format)


def Vgg_19(class_num: int = 1000, data_format: str = "NCHW") -> nn.Sequential:
    return _vgg_plain([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                       512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
                      class_num, data_format)
