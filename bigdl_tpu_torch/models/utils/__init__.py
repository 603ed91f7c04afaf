"""Language-model corpus and dataset helpers and the checkpoint
plumbing shared by the CLIs (port of
``bigdl_tpu/models/utils/__init__.py``: ``lm_corpus``,
``lm_sample_pipe``, ``lm_dataset``, ``restore_optim_state``,
``resolve_resume``; and the synthetic corpus of
``bigdl_tpu/models/rnn/train.py``).

The package also holds the measurement CLIs ``attention_bench`` (the
flash train step against plain attention, and the tile sweep into the
tuning cache) and ``lm_perf`` (TransformerLM train-step throughput)."""
from __future__ import annotations

import logging

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


def restore_optim_state(optimizer, method, state_path: str) -> None:
    """Load a ``state.<n>`` file (either package's) into (optimizer,
    method): the driver state through ``set_state``, the method's state
    onto the model's device as ``method._state``.  A file written by
    another method class is refused (Adam's moments fed to SGD would be
    dropped without a word)."""
    from bigdl_tpu_torch.utils import file_io
    snap = file_io.load(state_path)
    saved = snap.get("optim_method")
    if saved is not None and saved != type(method).__name__:
        raise SystemExit(
            f"checkpoint {state_path} was written by {saved} but this run "
            f"is configured with {type(method).__name__}: pass the "
            f"matching optimizer flag (state trees are not "
            f"interchangeable)")
    optimizer.set_state(snap["driver_state"])
    if snap.get("optim_state") is not None:
        method._state = file_io.state_from_numpy(snap["optim_state"],
                                                 optimizer.model.device)


def resolve_resume(args) -> None:
    """``--resume <dir>``: point ``--model``/``--state`` at the
    directory's newest checkpoint pair.  An empty or missing directory
    is a cold start; ``--model``/``--state`` beside ``--resume`` is an
    error."""
    if not getattr(args, "resume", None):
        return
    if getattr(args, "model", None) or getattr(args, "state", None):
        raise SystemExit("--resume picks the newest checkpoint itself; "
                         "drop --model/--state (or drop --resume)")
    from bigdl_tpu_torch.utils import file_io
    found = file_io.latest_checkpoint(args.resume)
    if found is None:
        logging.getLogger("bigdl_tpu_torch").info(
            "no checkpoints under %s yet: starting fresh", args.resume)
        return
    args.model, args.state = found[0], found[1]
