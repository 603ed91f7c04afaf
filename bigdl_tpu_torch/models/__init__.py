"""The model zoo (port of ``bigdl_tpu/models``): the image classifiers
and their CLIs, the transformer language model and its CLIs, and the
perf harnesses in ``models/utils``.  The recurrent, text-classifier and
autoencoder models are ROADMAP Queue 1 item 12."""
from bigdl_tpu_torch.models.alexnet import AlexNet
from bigdl_tpu_torch.models.inception import Inception_v1, Inception_v2
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "Inception_v1", "Inception_v2", "LeNet5", "ResNet",
           "TransformerLM", "Vgg_16", "Vgg_19", "VggForCifar10"]
