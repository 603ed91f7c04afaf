"""Host-side data pipeline (port of ``bigdl_tpu/dataset``): local
datasets, transformers, the text and image pipelines, the MNIST and
CIFAR-10 readers, record shards (``seqfile``) and Hadoop SequenceFiles
(``hadoop_seqfile``), and ``DistributedDataSet``, one rank's shard."""
from bigdl_tpu_torch.dataset import (cifar, hadoop_seqfile, image, mnist,
                                     seqfile)
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             DistributedDataSet,
                                             LocalArrayDataSet, LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Prefetcher,
                                                 SampleToBatch, Transformer)
from bigdl_tpu_torch.dataset.types import (ByteRecord, LabeledImage,
                                           LabeledSentence, MiniBatch, Sample)

__all__ = ["AbstractDataSet", "ByteRecord", "ChainedTransformer", "DataSet",
           "DistributedDataSet",
           "FuncTransformer", "LabeledImage", "LabeledSentence",
           "LocalArrayDataSet", "LocalDataSet", "MiniBatch", "Prefetcher", "Sample",
           "SampleToBatch", "TransformedDataSet", "Transformer", "cifar",
           "hadoop_seqfile", "image", "mnist", "seqfile"]
