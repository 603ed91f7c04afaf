"""Autoencoder for MNIST (port of ``bigdl_tpu/models/autoencoder``; ref
models/autoencoder/Autoencoder.scala): 784 -> 32 -> 784 with a ReLU
code and a sigmoid reconstruction.  The CLIs are
``models.autoencoder.train`` and ``models.autoencoder.test``."""
from bigdl_tpu_torch import nn


def Autoencoder(class_num: int = 32) -> nn.Sequential:
    row_n, col_n = 28, 28
    return nn.Sequential(
        nn.Reshape((row_n * col_n,)),
        nn.Linear(row_n * col_n, class_num),
        nn.ReLU(True),
        nn.Linear(class_num, row_n * col_n),
        nn.Sigmoid(),
    )
