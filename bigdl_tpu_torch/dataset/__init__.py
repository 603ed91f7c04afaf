"""Host-side data pipeline (port of ``bigdl_tpu/dataset``): local
datasets, transformers, the text and image pipelines and the MNIST and
CIFAR-10 readers.  The SequenceFile readers and distributed datasets are
ROADMAP Queue 1 item 12."""
from bigdl_tpu_torch.dataset import cifar, image, mnist
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet, LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Prefetcher,
                                                 SampleToBatch, Transformer)
from bigdl_tpu_torch.dataset.types import (ByteRecord, LabeledImage,
                                           LabeledSentence, MiniBatch, Sample)

__all__ = ["AbstractDataSet", "ByteRecord", "ChainedTransformer", "DataSet",
           "FuncTransformer", "LabeledImage", "LabeledSentence",
           "LocalArrayDataSet", "LocalDataSet", "MiniBatch", "Prefetcher", "Sample",
           "SampleToBatch", "TransformedDataSet", "Transformer", "cifar",
           "image", "mnist"]
