"""The model zoo (port of ``bigdl_tpu/models``): the image classifiers,
the recurrent language models, the text classifier and the autoencoder
with their CLIs, the transformer language model and its CLIs, and the
perf harnesses in ``models/utils``."""
from bigdl_tpu_torch.models.alexnet import AlexNet
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import Inception_v1, Inception_v2
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.rnn import LstmLM, SimpleRNN
from bigdl_tpu_torch.models.textclassifier import (
    TextClassifier, TextClassifierWithEmbedding)
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "Autoencoder", "Inception_v1", "Inception_v2",
           "LeNet5", "LstmLM", "ResNet", "SimpleRNN", "TextClassifier",
           "TextClassifierWithEmbedding", "TransformerLM", "Vgg_16", "Vgg_19",
           "VggForCifar10"]
