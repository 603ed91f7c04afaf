"""The recurrent language models (port of ``bigdl_tpu/models/rnn``; ref
models/rnn/SimpleRNN.scala): a ``Recurrent`` cell over one-hot inputs,
then a time-distributed ``Linear`` + ``LogSoftMax`` head.  The CLIs are
``models.rnn.train`` and ``models.rnn.test``."""
from bigdl_tpu_torch import nn


def SimpleRNN(input_size: int = 4000, hidden_size: int = 40,
              output_size: int = 4000) -> nn.Sequential:
    """Elman (tanh) cell language model (ref SimpleRNN.scala:22)."""
    return nn.Sequential(
        nn.Recurrent(nn.RnnCell(input_size, hidden_size, nn.Tanh())),
        nn.TimeDistributed(nn.Sequential(
            nn.Linear(hidden_size, output_size),
            nn.LogSoftMax(),
        )),
    )


def LstmLM(input_size: int = 4000, hidden_size: int = 128,
           output_size: int = 4000) -> nn.Sequential:
    """The LSTM variant of the language model (the reference's rnn
    example with its cell swapped for an LSTM)."""
    return nn.Sequential(
        nn.Recurrent(nn.LSTM(input_size, hidden_size)),
        nn.TimeDistributed(nn.Sequential(
            nn.Linear(hidden_size, output_size),
            nn.LogSoftMax(),
        )),
    )
