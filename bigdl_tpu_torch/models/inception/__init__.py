"""Inception / GoogLeNet (port of ``bigdl_tpu/models/inception``; ref
models/inception/Inception_v1.scala:24-96, Inception_v2.scala):
Concat-based inception modules.

Module config follows the reference: each inception block is a 4-branch
Concat over channel dim — 1x1 / 1x1->3x3 / 1x1->5x5 (v1; double-3x3 in v2)
/ pool->1x1.
"""
from __future__ import annotations

from bigdl_tpu_torch import nn


def _inception_v1_module(n_in: int, config, df: str = "NCHW") -> nn.Module:
    """config = ((c1), (c3r, c3), (c5r, c5), (pool_proj)) as in the
    reference's Table-driven inception() (Inception_v1.scala:24-60)."""
    (c1,), (c3r, c3), (c5r, c5), (cp,) = config
    return nn.Concat(
        2 if df == "NCHW" else 4,
        nn.Sequential(
            nn.SpatialConvolution(n_in, c1, 1, 1, data_format=df), nn.ReLU(True)),
        nn.Sequential(
            nn.SpatialConvolution(n_in, c3r, 1, 1, data_format=df), nn.ReLU(True),
            nn.SpatialConvolution(c3r, c3, 3, 3, 1, 1, 1, 1, data_format=df), nn.ReLU(True)),
        nn.Sequential(
            nn.SpatialConvolution(n_in, c5r, 1, 1, data_format=df), nn.ReLU(True),
            nn.SpatialConvolution(c5r, c5, 5, 5, 1, 1, 2, 2, data_format=df), nn.ReLU(True)),
        nn.Sequential(
            nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1, data_format=df).ceil(),
            nn.SpatialConvolution(n_in, cp, 1, 1, data_format=df), nn.ReLU(True)),
    )


def Inception_v1(class_num: int = 1000, has_dropout: bool = True,
                 data_format: str = "NCHW") -> nn.Sequential:
    """GoogLeNet main tower (ref Inception_v1.scala; the reference's factory
    builds the no-aux-classifier variant used by the perf harness)."""
    df = data_format
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, data_format=df).set_name("conv1/7x7_s2"),
        nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil(),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, data_format=df),
        nn.SpatialConvolution(64, 64, 1, 1, data_format=df).set_name("conv2/3x3_reduce"),
        nn.ReLU(True),
        nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, data_format=df).set_name("conv2/3x3"),
        nn.ReLU(True),
        nn.SpatialCrossMapLRN(5, 0.0001, 0.75, data_format=df),
        nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil(),
    )
    m.add(_inception_v1_module(192, ((64,), (96, 128), (16, 32), (32,)), df))   # 3a
    m.add(_inception_v1_module(256, ((128,), (128, 192), (32, 96), (64,)), df))  # 3b
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil())
    m.add(_inception_v1_module(480, ((192,), (96, 208), (16, 48), (64,)), df))   # 4a
    m.add(_inception_v1_module(512, ((160,), (112, 224), (24, 64), (64,)), df))  # 4b
    m.add(_inception_v1_module(512, ((128,), (128, 256), (24, 64), (64,)), df))  # 4c
    m.add(_inception_v1_module(512, ((112,), (144, 288), (32, 64), (64,)), df))  # 4d
    m.add(_inception_v1_module(528, ((256,), (160, 320), (32, 128), (128,)), df))  # 4e
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil())
    m.add(_inception_v1_module(832, ((256,), (160, 320), (32, 128), (128,)), df))  # 5a
    m.add(_inception_v1_module(832, ((384,), (192, 384), (48, 128), (128,)), df))  # 5b
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, data_format=df))
    if has_dropout:
        m.add(nn.Dropout(0.4))
    m.add(nn.View(1024))
    m.add(nn.Linear(1024, class_num).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m


def _inception_v2_module(n_in: int, config, downsample: bool = False,
                         df: str = "NCHW") -> nn.Module:
    """BN-Inception module: 5x5 branch replaced by double-3x3
    (ref Inception_v2.scala)."""
    (c1,), (c3r, c3), (cdr, cd3), (cp,) = config
    stride = 2 if downsample else 1
    branches = []
    if c1 > 0:
        branches.append(nn.Sequential(
            nn.SpatialConvolution(n_in, c1, 1, 1, data_format=df),
            nn.SpatialBatchNormalization(c1, eps=1e-3, data_format=df), nn.ReLU(True)))
    branches.append(nn.Sequential(
        nn.SpatialConvolution(n_in, c3r, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(c3r, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialConvolution(c3r, c3, 3, 3, stride, stride, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(c3, eps=1e-3, data_format=df), nn.ReLU(True)))
    branches.append(nn.Sequential(
        nn.SpatialConvolution(n_in, cdr, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(cdr, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialConvolution(cdr, cd3, 3, 3, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(cd3, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialConvolution(cd3, cd3, 3, 3, stride, stride, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(cd3, eps=1e-3, data_format=df), nn.ReLU(True)))
    if downsample:
        branches.append(nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil())
    else:
        branches.append(nn.Sequential(
            nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, data_format=df),
            nn.SpatialConvolution(n_in, cp, 1, 1, data_format=df),
            nn.SpatialBatchNormalization(cp, eps=1e-3, data_format=df), nn.ReLU(True)))
    return nn.Concat(2 if df == "NCHW" else 4, *branches)


def Inception_v2(class_num: int = 1000, data_format: str = "NCHW") -> nn.Sequential:
    df = data_format
    m = nn.Sequential(
        nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, data_format=df),
        nn.SpatialBatchNormalization(64, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil(),
        nn.SpatialConvolution(64, 64, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(64, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, data_format=df),
        nn.SpatialBatchNormalization(192, eps=1e-3, data_format=df), nn.ReLU(True),
        nn.SpatialMaxPooling(3, 3, 2, 2, data_format=df).ceil(),
    )
    m.add(_inception_v2_module(192, ((64,), (64, 64), (64, 96), (32,)), df=df))    # 3a
    m.add(_inception_v2_module(256, ((64,), (64, 96), (64, 96), (64,)), df=df))    # 3b
    m.add(_inception_v2_module(320, ((0,), (128, 160), (64, 96), (0,)), downsample=True, df=df))  # 3c
    m.add(_inception_v2_module(576, ((224,), (64, 96), (96, 128), (128,)), df=df))  # 4a
    m.add(_inception_v2_module(576, ((192,), (96, 128), (96, 128), (128,)), df=df))  # 4b
    m.add(_inception_v2_module(576, ((160,), (128, 160), (128, 160), (96,)), df=df))  # 4c
    m.add(_inception_v2_module(576, ((96,), (128, 192), (160, 192), (96,)), df=df))  # 4d
    m.add(_inception_v2_module(576, ((0,), (128, 192), (192, 256), (0,)), downsample=True, df=df))  # 4e
    m.add(_inception_v2_module(1024, ((352,), (192, 320), (160, 224), (128,)), df=df))  # 5a
    m.add(_inception_v2_module(1024, ((352,), (192, 320), (192, 224), (128,)), df=df))  # 5b
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, data_format=df))
    m.add(nn.View(1024))
    m.add(nn.Linear(1024, class_num))
    m.add(nn.LogSoftMax())
    return m
