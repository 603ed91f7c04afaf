"""Host utilities of the port: the ``Table``/``T`` activity container,
``Engine``, the key chain, parameter trees, file IO, and the Torch7 and
PyTorch model-file readers and writers (``torch_file``,
``torch_import``)."""
from bigdl_tpu_torch.utils import torch_file, torch_import
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["Table", "T", "Engine", "torch_file", "torch_import"]
