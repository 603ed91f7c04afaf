"""Text classifier (port of ``bigdl_tpu/models/textclassifier``; ref
example/textclassification/TextClassifier.scala:122-176: GloVe
embeddings and a convolutional classifier, plus the LSTM encoder the
benchmark configs name).

``TextClassifier`` takes (batch, seq_len, embed_dim) sequences embedded
in the data pipeline, as the reference's; ``TextClassifierWithEmbedding``
starts from 1-based token ids through a ``LookupTable``.  The CLIs are
``models.textclassifier.train`` and ``models.textclassifier.test``."""
from bigdl_tpu_torch import nn


def TextClassifier(class_num: int = 20, embed_dim: int = 100,
                   seq_len: int = 500, encoder: str = "cnn",
                   hidden: int = 128) -> nn.Sequential:
    if encoder == "cnn":
        # the sequence as a 1 x seq_len x embed_dim image; the
        # convolution's kernel in BigDL's (kW, kH) order spans the
        # embedding and 5 tokens
        flat = 128 * ((((seq_len - 4) // 5) - 4) // 5)
        return nn.Sequential(
            nn.Reshape((1, seq_len, embed_dim)),
            nn.SpatialConvolution(1, 128, embed_dim, 5),
            nn.ReLU(True),
            nn.SpatialMaxPooling(1, 5, 1, 5),
            nn.SpatialConvolution(128, 128, 1, 5),
            nn.ReLU(True),
            nn.SpatialMaxPooling(1, 5, 1, 5),
            nn.Reshape((flat,)),
            nn.Linear(flat, 100),
            nn.Linear(100, class_num),
            nn.LogSoftMax(),
        )
    if encoder == "lstm":
        return nn.Sequential(
            nn.Recurrent(nn.LSTM(embed_dim, hidden)),
            nn.Select(2, -1),  # the last timestep
            nn.Linear(hidden, class_num),
            nn.LogSoftMax(),
        )
    raise ValueError(f"unknown encoder {encoder!r}")


def TextClassifierWithEmbedding(vocab_size: int, class_num: int = 20,
                                embed_dim: int = 100,
                                hidden: int = 128) -> nn.Sequential:
    return nn.Sequential(
        nn.LookupTable(vocab_size, embed_dim),
        nn.Recurrent(nn.LSTM(embed_dim, hidden)),
        nn.Select(2, -1),
        nn.Linear(hidden, class_num),
        nn.LogSoftMax(),
    )
