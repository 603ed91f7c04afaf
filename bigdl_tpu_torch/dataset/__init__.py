"""Host-side data pipeline (port of ``bigdl_tpu/dataset``, the parts the
language-model training path uses)."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.transformer import SampleToBatch, Transformer
from bigdl_tpu_torch.dataset.types import LabeledSentence, MiniBatch, Sample

__all__ = ["AbstractDataSet", "DataSet", "LabeledSentence",
           "LocalArrayDataSet", "MiniBatch", "Sample", "SampleToBatch",
           "TransformedDataSet", "Transformer"]
