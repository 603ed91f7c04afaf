"""Image transformers (port of ``bigdl_tpu/dataset/image.py``): decode,
augment, normalize and batch.  Images are (C, H, W) float32 numpy on the
host, colour ones in BGR order as the reference keeps them.

The random transformers (``HFlip``, ``BGRImgRdmCropper``,
``ColorJitter``, ``Lighting``) draw from the Torch-compatible MT19937
(``utils/rng.py``), so the same seed gives the reference's flips, crops
and jitter.  Decoding encoded images needs PIL, imported only when an
image is decoded or resized; no path of the port's training or its
synthetic data decodes one.
"""
from __future__ import annotations

import io
from typing import Iterator

import numpy as np

from bigdl_tpu_torch.dataset.transformer import (Prefetcher, SampleToBatch,
                                                 Transformer)
from bigdl_tpu_torch.dataset.types import (ByteRecord, LabeledImage,
                                           MiniBatch, Sample)
from bigdl_tpu_torch.utils.rng import RandomGenerator


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image decoding and resizing require PIL "
                           "(the Pillow package)") from e
    return Image


def _decode_image(data: bytes) -> np.ndarray:
    """bytes -> HWC uint8 RGB."""
    img = _pil().open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


class BytesToGreyImg(Transformer):
    """Raw row-major grey bytes (MNIST) -> LabeledImage (1, H, W)
    (ref dataset/image/BytesToGreyImg.scala)."""

    def __init__(self, row: int, col: int):
        self.row = row
        self.col = col

    def transform_one(self, r: ByteRecord) -> LabeledImage:
        arr = np.frombuffer(r.data, dtype=np.uint8).reshape(self.row, self.col)
        return LabeledImage(arr[None].astype(np.float32), r.label)


class BytesToBGRImg(Transformer):
    """Encoded image bytes -> LabeledImage (3, H, W), BGR in [0, 255]
    (ref dataset/image/BytesToBGRImg.scala)."""

    def transform_one(self, r: ByteRecord) -> LabeledImage:
        bgr = _decode_image(r.data).astype(np.float32)[:, :, ::-1]
        return LabeledImage(np.ascontiguousarray(bgr.transpose(2, 0, 1)),
                            r.label)


class LocalImgReader(Transformer):
    """(path, label) -> LabeledImage, the shorter side resized to
    ``scale_to`` when positive (ref dataset/image/LocalImgReader.scala)."""

    def __init__(self, scale_to: int = -1):
        self.scale_to = scale_to

    def transform_one(self, rec) -> LabeledImage:
        path, label = rec
        with open(path, "rb") as f:
            rgb = _decode_image(f.read())
        if self.scale_to > 0:
            h, w = rgb.shape[:2]
            if h < w:
                nh, nw = self.scale_to, int(w * self.scale_to / h)
            else:
                nh, nw = int(h * self.scale_to / w), self.scale_to
            rgb = np.asarray(_pil().fromarray(rgb).resize((nw, nh)),
                             dtype=np.uint8)
        bgr = rgb[:, :, ::-1].astype(np.float32)
        return LabeledImage(np.ascontiguousarray(bgr.transpose(2, 0, 1)),
                            float(label))


class GreyFromBGR(Transformer):
    """(3, H, W) BGR -> (1, H, W) luminance (BT.601 weights)."""

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        b, g, r = img.data[0], img.data[1], img.data[2]
        grey = 0.114 * b + 0.587 * g + 0.299 * r
        return LabeledImage(grey[None].astype(np.float32), img.label)


class GreyImgNormalizer(Transformer):
    """(x - mean) / std (ref dataset/image/GreyImgNormalizer.scala), the
    statistics given or ``fit`` over a dataset."""

    def __init__(self, mean: float, std: float):
        self.mean = mean
        self.std = std

    @staticmethod
    def fit(dataset, max_samples: int = 10000) -> "GreyImgNormalizer":
        total, sq, n = 0.0, 0.0, 0
        for i, img in enumerate(dataset.data(train=False)):
            if i >= max_samples:
                break
            total += float(img.data.sum())
            sq += float((img.data ** 2).sum())
            n += img.data.size
        mean = total / n
        return GreyImgNormalizer(mean, float(np.sqrt(sq / n - mean * mean)))

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        return LabeledImage((img.data - self.mean) / self.std, img.label)


class BGRImgNormalizer(Transformer):
    """Per-channel (x - mean) / std, channels in BGR order
    (ref dataset/image/BGRImgNormalizer.scala)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, dtype=np.float32).reshape(3, 1, 1)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        return LabeledImage((img.data - self.mean) / self.std, img.label)


class BGRImgPixelNormalizer(Transformer):
    """Subtract a full per-pixel mean image
    (ref dataset/image/BGRImgPixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, dtype=np.float32)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        return LabeledImage(img.data - self.means, img.label)


class HFlip(Transformer):
    """Horizontal flip with probability ``threshold``
    (ref dataset/image/HFlip.scala)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = RandomGenerator(seed)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        if self._rng.random() < self.threshold:
            return LabeledImage(np.ascontiguousarray(img.data[:, :, ::-1]),
                                img.label)
        return img


class _Cropper(Transformer):
    def __init__(self, crop_w: int, crop_h: int, random: bool, seed: int = 0):
        self.crop_w = crop_w
        self.crop_h = crop_h
        self.random = random
        self._rng = RandomGenerator(seed)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        _, h, w = img.data.shape
        if self.random:
            y0 = int(self._rng.random() * (h - self.crop_h + 1))
            x0 = int(self._rng.random() * (w - self.crop_w + 1))
        else:
            y0 = (h - self.crop_h) // 2
            x0 = (w - self.crop_w) // 2
        patch = img.data[:, y0:y0 + self.crop_h, x0:x0 + self.crop_w]
        return LabeledImage(np.ascontiguousarray(patch), img.label)


class BGRImgCropper(_Cropper):
    """Center crop (ref dataset/image/BGRImgCropper.scala)."""

    def __init__(self, crop_w: int, crop_h: int):
        super().__init__(crop_w, crop_h, random=False)


class BGRImgRdmCropper(_Cropper):
    """Random crop (ref dataset/image/BGRImgRdmCropper.scala)."""

    def __init__(self, crop_w: int, crop_h: int, seed: int = 0):
        super().__init__(crop_w, crop_h, random=True, seed=seed)


class GreyImgCropper(_Cropper):
    def __init__(self, crop_w: int, crop_h: int):
        super().__init__(crop_w, crop_h, random=False)


class ColorJitter(Transformer):
    """Brightness, contrast and saturation each scaled by a factor in
    [1-d, 1+d], in a random order (ref dataset/image/ColoJitter.scala)."""

    def __init__(self, delta: float = 0.4, seed: int = 0):
        self.delta = delta
        self._rng = RandomGenerator(seed)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        x = img.data
        for op in self._rng.randperm(3):
            a = 1.0 + self._rng.uniform(-self.delta, self.delta)
            if op == 1:  # brightness
                x = x * a
            elif op == 2:  # contrast
                x = (x - x.mean()) * a + x.mean()
            else:  # saturation: blend with the per-pixel grey
                grey = x.mean(axis=0, keepdims=True)
                x = x * a + grey * (1 - a)
        return LabeledImage(x.astype(np.float32), img.label)


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise on BGR images
    (ref dataset/image/Lighting.scala)."""

    _eigval = np.asarray([0.2175, 0.0188, 0.0045], dtype=np.float32)
    _eigvec = np.asarray([
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ], dtype=np.float32)

    def __init__(self, alpha_std: float = 0.1, seed: int = 0):
        self.alpha_std = alpha_std
        self._rng = RandomGenerator(seed)

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        alpha = np.asarray([self._rng.uniform(0, self.alpha_std)
                            for _ in range(3)], dtype=np.float32)
        delta = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return LabeledImage(img.data + delta.reshape(3, 1, 1), img.label)


class _ImgToSample(Transformer):
    def transform_one(self, img: LabeledImage) -> Sample:
        return Sample(img.data, np.asarray(img.label, dtype=np.float32))


class GreyImgToSample(_ImgToSample):
    pass


class BGRImgToSample(_ImgToSample):
    pass


class GreyImgToBatch(Transformer):
    """LabeledImage stream -> MiniBatch stream
    (ref dataset/image/GreyImgToBatch.scala)."""

    def __init__(self, batch_size: int):
        self._chain = _ImgToSample() >> SampleToBatch(batch_size)

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        return self._chain(it)


class BGRImgToBatch(GreyImgToBatch):
    pass


class BatchToNHWC(Transformer):
    """MiniBatch (N, C, H, W) -> (N, H, W, C), to feed a
    ``data_format="NHWC"`` model from the NCHW pipeline: one host
    transpose a batch."""

    def transform_one(self, b: MiniBatch) -> MiniBatch:
        return MiniBatch(np.ascontiguousarray(b.data.transpose(0, 2, 3, 1)),
                         b.labels)


class _EnsureSize(Transformer):
    """Force (C, height, width): center-crop when larger, bilinear
    resize (PIL) otherwise."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    def transform_one(self, img: LabeledImage) -> LabeledImage:
        c, h, w = img.data.shape
        if (h, w) == (self.height, self.width):
            return img
        if h >= self.height and w >= self.width:
            y0 = (h - self.height) // 2
            x0 = (w - self.width) // 2
            patch = img.data[:, y0:y0 + self.height, x0:x0 + self.width]
            return LabeledImage(np.ascontiguousarray(patch), img.label)
        image = _pil()
        hwc = img.data.transpose(1, 2, 0)
        resized = np.stack([
            np.asarray(image.fromarray(hwc[:, :, i]).resize(
                (self.width, self.height), image.BILINEAR))
            for i in range(c)])
        return LabeledImage(resized.astype(np.float32), img.label)


class MTLabeledBGRImgToBatch(Transformer):
    """Decode and batch at a fixed output size on a background thread
    (ref dataset/image/MTLabeledBGRImgToBatch.scala): ``transformer``,
    then the size forced by ``_EnsureSize``, then batches, behind a
    ``Prefetcher`` of ``depth``."""

    def __init__(self, width: int, height: int, batch_size: int,
                 transformer: Transformer, depth: int = 8,
                 data_format: str = "NCHW"):
        chain = transformer >> _EnsureSize(width, height) >> \
            _ImgToSample() >> SampleToBatch(batch_size)
        if data_format == "NHWC":
            chain = chain >> BatchToNHWC()  # the worker does the transpose
        elif data_format != "NCHW":
            raise ValueError(f"unsupported data_format {data_format!r}")
        self._chain = chain >> Prefetcher(depth)

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        return self._chain(it)
