"""LeNet-5 (port of ``bigdl_tpu/models/lenet``; ref
models/lenet/LeNet5.scala:24-37).

conv(1->6,5x5) tanh pool conv(6->12,5x5) tanh pool fc100 tanh fc<classes>
log-softmax, on 28x28 MNIST images.
"""
from bigdl_tpu_torch import nn


def LeNet5(class_num: int = 10) -> nn.Sequential:
    return nn.Sequential(
        nn.Reshape((1, 28, 28)),
        nn.SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Reshape((12 * 4 * 4,)),
        nn.Linear(12 * 4 * 4, 100).set_name("fc_1"),
        nn.Tanh(),
        nn.Linear(100, class_num).set_name("fc_2"),
        nn.LogSoftMax(),
    )
