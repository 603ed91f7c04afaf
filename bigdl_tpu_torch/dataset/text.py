"""Text transformers (port of ``bigdl_tpu/dataset/text.py``):
SentenceSplitter, SentenceTokenizer, SentenceBiPadding,
Dictionary (with its JSON save and load), TextToLabeledSentence, DocumentPacker and
LabeledSentenceToSample.  The pipeline is host-side numpy, as in the
JAX package, and yields the same records for the same text.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Iterable, Iterator, Optional

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.dataset.types import LabeledSentence, Sample

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"


class SentenceSplitter(Transformer):
    """Document string -> sentence strings."""

    _pat = re.compile(r"(?<=[.!?])\s+")

    def __call__(self, it: Iterator[str]) -> Iterator[str]:
        for doc in it:
            for s in self._pat.split(doc.strip()):
                if s:
                    yield s


class SentenceTokenizer(Transformer):
    """Sentence string -> lower-cased token list (words and single
    punctuation marks).  The host library's tokenizer does the work;
    the regex is the path under ``BIGDL_TPU_NO_NATIVE=1`` and its
    oracle."""

    _pat = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9]")

    def transform_one(self, sentence: str) -> list[str]:
        lowered = sentence.lower()
        lib = native.get()
        if lib is not None:
            return lib.tokenize(lowered)
        return self._pat.findall(lowered)


class SentenceBiPadding(Transformer):
    """Add start/end markers."""

    def transform_one(self, tokens: list[str]) -> list[str]:
        return [SENTENCE_START] + list(tokens) + [SENTENCE_END]


class Dictionary:
    """Vocabulary built from token streams: keeps the ``vocab_size`` most
    frequent words, everything else maps to an unknown id.  Word ids are
    0-based; samples add 1."""

    UNK = "<unk>"

    def __init__(self, tokens_stream: Optional[Iterable[list[str]]] = None,
                 vocab_size: int = 10000):
        self.word2index: dict[str, int] = {}
        self.index2word: dict[int, str] = {}
        self._unk_index = 0
        if tokens_stream is not None:
            counts = Counter()
            for tokens in tokens_stream:
                counts.update(tokens)
            kept = [w for w, _ in counts.most_common(vocab_size)]
            for i, w in enumerate(kept):
                self.word2index[w] = i
                self.index2word[i] = w
            self._unk_index = len(kept)

    def vocab_size(self) -> int:
        return len(self.word2index) + 1  # + unknown

    def get_index(self, word: str) -> int:
        return self.word2index.get(word, self._unk_index)

    def get_word(self, index: int) -> str:
        return self.index2word.get(index, self.UNK)

    def save(self, path: str) -> None:
        """Write ``{"word2index": ...}`` as JSON through the port's
        ``fs`` (a local path, ``file://`` or ``memory://``), the file the
        reference writes."""
        from bigdl_tpu_torch.utils import fs
        fs.atomic_write(path,
                        json.dumps({"word2index": self.word2index}).encode())

    @staticmethod
    def load(path: str) -> "Dictionary":
        from bigdl_tpu_torch.utils import fs
        d = Dictionary()
        with fs.open_file(path, "rb") as f:
            d.word2index = json.loads(f.read().decode())["word2index"]
        d.index2word = {i: w for w, i in d.word2index.items()}
        d._unk_index = len(d.word2index)
        return d


class TextToLabeledSentence(Transformer):
    """Token list -> LabeledSentence for next-token language modelling:
    data = ids[:-1], label = ids[1:]."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def transform_one(self, tokens: list[str]) -> LabeledSentence:
        ids = np.asarray([self.dictionary.get_index(t) for t in tokens],
                         dtype=np.float32)
        return LabeledSentence(ids[:-1], ids[1:])


class DocumentPacker(Transformer):
    """Concatenate token streams and emit dense fixed-length next-token
    windows (ids[:T], ids[1:T+1]); only the final partial window is
    dropped.  ``stride`` < ``seq_length`` gives overlapping windows."""

    def __init__(self, dictionary: Dictionary, seq_length: int,
                 stride: Optional[int] = None):
        self.dictionary = dictionary
        self.seq_length = int(seq_length)
        self.stride = int(stride) if stride is not None else int(seq_length)
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")

    def __call__(self, it: Iterator[list]) -> Iterator[LabeledSentence]:
        buf: list = []
        t = self.seq_length
        for tokens in it:
            buf.extend(self.dictionary.get_index(tok) for tok in tokens)
            # windows need t+1 ids (input t, target shifted by one)
            while len(buf) >= t + 1:
                ids = np.asarray(buf[:t + 1], dtype=np.float32)
                yield LabeledSentence(ids[:-1], ids[1:])
                del buf[:self.stride]


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample, one-hot or 1-based id features and
    1-based labels, padded/truncated to ``fixed_length`` when given."""

    def __init__(self, vocab_size: int, fixed_length: Optional[int] = None,
                 one_hot: bool = True, pad_label: float = 1.0):
        self.vocab_size = vocab_size
        self.fixed_length = fixed_length
        self.one_hot = one_hot
        # pad_label must be a VALID 1-based class: ClassNLLCriterion maps
        # label-1 to an index, so 0 would silently wrap to the last class
        if not (1 <= pad_label <= vocab_size):
            raise ValueError(f"pad_label {pad_label} outside [1, {vocab_size}]")
        self.pad_label = pad_label

    def transform_one(self, s: LabeledSentence) -> Sample:
        n = len(s.data)
        length = self.fixed_length if self.fixed_length is not None else n
        ids = np.zeros(length, dtype=np.int64)
        ids[:min(n, length)] = s.data[:length].astype(np.int64)
        labels = np.full(length, self.pad_label, dtype=np.float32)
        m = min(len(s.label), length)
        labels[:m] = s.label[:m] + 1.0  # 1-based class targets
        if self.one_hot:
            feat = np.zeros((length, self.vocab_size), dtype=np.float32)
            feat[np.arange(length), ids] = 1.0
        else:
            feat = (ids + 1).astype(np.float32)  # 1-based for the embedding
        return Sample(feat, labels)
