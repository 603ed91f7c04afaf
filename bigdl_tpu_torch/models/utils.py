"""Language-model corpus and dataset helpers shared by the train CLIs
(port of ``bigdl_tpu/models/utils/__init__.py``: ``lm_corpus``,
``lm_sample_pipe``, ``lm_dataset``; and the synthetic corpus of
``bigdl_tpu/models/rnn/train.py``)."""
from __future__ import annotations

from bigdl_tpu_torch.dataset import DataSet, SampleToBatch, text

SYNTH_CORPUS = ("the quick brown fox jumps over the lazy dog. "
                "pack my box with five dozen liquor jugs. "
                "how vexingly quick daft zebras jump! ") * 40


def lm_corpus(raw: str, vocab_size: int, dictionary=None):
    """Tokenize a raw corpus into bi-padded sentences and build (or
    reuse) its Dictionary.  Returns (token_lists, dictionary)."""
    tokenize = text.SentenceSplitter() >> text.SentenceTokenizer() \
        >> text.SentenceBiPadding()
    token_lists = list(tokenize([raw]))
    if dictionary is None:
        dictionary = text.Dictionary(token_lists, vocab_size=vocab_size)
    return token_lists, dictionary


def lm_sample_pipe(dictionary, seq_length: int, batch_size: int,
                   one_hot: bool = True):
    """token list -> next-token Sample -> padded batch; the pad label is
    the sentence-end token's 1-based id."""
    vocab = dictionary.vocab_size()
    pad_label = dictionary.get_index(text.SENTENCE_END) + 1
    return (text.TextToLabeledSentence(dictionary)
            >> text.LabeledSentenceToSample(vocab, fixed_length=seq_length,
                                            one_hot=one_hot,
                                            pad_label=pad_label)
            >> SampleToBatch(batch_size))


def lm_dataset(token_lists, dictionary, seq_length: int, batch_size: int,
               one_hot: bool = False, packed: bool = False,
               distributed: bool = False):
    """The LM DataSet for a list of token lists.

    ``packed=False``: one padded sample per sentence.  ``packed=True``:
    documents are packed into dense windows eagerly and the windows are
    the records, so ``dataset.size()`` counts windows.  A corpus that
    cannot fill one window raises ``SystemExit``."""
    if not packed:
        return DataSet.array(token_lists, distributed=distributed) >> \
            lm_sample_pipe(dictionary, seq_length, batch_size, one_hot)
    vocab = dictionary.vocab_size()
    pad_label = dictionary.get_index(text.SENTENCE_END) + 1
    windows = list(text.DocumentPacker(dictionary, seq_length)(
        iter(token_lists)))
    if not windows:
        total = sum(len(t) for t in token_lists)
        raise SystemExit(
            f"--packed: the corpus split has {total} tokens, fewer than "
            f"one {seq_length}-token window needs ({seq_length + 1}) — "
            f"reduce --seqLength or provide more text")
    to_sample = text.LabeledSentenceToSample(
        vocab, fixed_length=seq_length, one_hot=one_hot, pad_label=pad_label)
    return DataSet.array(windows, distributed=distributed) >> (
        to_sample >> SampleToBatch(batch_size))
