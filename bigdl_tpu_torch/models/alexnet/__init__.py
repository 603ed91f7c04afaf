"""AlexNet (port of ``bigdl_tpu/models/alexnet``; ref
example/loadmodel/AlexNet.scala + test
models/AlexNetSpec.scala): the original two-group Caffe variant with LRN.
"""
from bigdl_tpu_torch import nn


def AlexNet(class_num: int = 1000) -> nn.Sequential:
    return nn.Sequential(
        nn.SpatialConvolution(3, 96, 11, 11, 4, 4).set_name("conv1"),
        nn.ReLU(True),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"),
        nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2).set_name("conv2"),
        nn.ReLU(True),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"),
        nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1).set_name("conv3"),
        nn.ReLU(True),
        nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, n_group=2).set_name("conv4"),
        nn.ReLU(True),
        nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, n_group=2).set_name("conv5"),
        nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"),
        nn.View(256 * 6 * 6),
        nn.Linear(256 * 6 * 6, 4096).set_name("fc6"),
        nn.ReLU(True),
        nn.Dropout(0.5),
        nn.Linear(4096, 4096).set_name("fc7"),
        nn.ReLU(True),
        nn.Dropout(0.5),
        nn.Linear(4096, class_num).set_name("fc8"),
        nn.LogSoftMax(),
    )
