"""Language-model corpus and dataset helpers, the CIFAR-10 pipeline and
the checkpoint plumbing shared by the CLIs (port of
``bigdl_tpu/models/utils/__init__.py``: ``lm_corpus``,
``lm_sample_pipe``, ``lm_dataset``, ``restore_optim_state``,
``resolve_resume``, the ImageNet record-shard path
``imagenet_seq_datasets``/``imagenet_shards``/``imagenet_val_pipe``; the
synthetic corpus of ``bigdl_tpu/models/rnn/train.py``; and the CIFAR-10
datasets and eval main the vgg and resnet CLIs share).

The package also holds the measurement CLIs ``attention_bench`` (the
flash train step against plain attention, and the tile sweep into the
tuning cache), ``lm_perf`` (TransformerLM train-step throughput),
``perf`` (the image classifiers' train-step throughput) and
``pipeline_bench`` (ResNet-50 fed from record shards against
device-resident data), and the shard generator ``seqfile_generator``."""
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


def start_distributed(args) -> None:
    """``--distributed``: start the process world on ``--device`` before
    the model is built (``parallel.mesh.init_world``: torchrun's ranks,
    else a world of one), so the model lands on this rank's device and
    the training dataset is this rank's shard."""
    if getattr(args, "distributed", False):
        from bigdl_tpu_torch.parallel.mesh import init_world
        init_world(getattr(args, "device", None))


IMAGENET_BGR_MEAN = (104.0, 117.0, 123.0)
IMAGENET_BGR_STD = (1.0, 1.0, 1.0)


def imagenet_seq_datasets(folder: str, batch_size: int,
                          distributed: bool = False,
                          data_format: str = "NCHW"):
    """The reference's ImageNet input path, shared by the conv-net CLIs
    (ref dataset/DataSet.scala:380-433 SeqFileFolder + the ImageNet2012
    pipeline): shard folder -> per-record decode (record shards or
    .seq) -> 224 random crop and flip (train) / center crop (val) ->
    normalize -> threaded batcher.  Returns (train_ds, val_ds)."""
    from bigdl_tpu_torch.dataset import image
    from bigdl_tpu_torch.dataset.hadoop_seqfile import AnyBytesToBGRImg

    train, val = imagenet_shards(folder)
    train_ds = DataSet.record_files(train, distributed=distributed)
    val_ds = DataSet.record_files(val)
    train_pipe = image.MTLabeledBGRImgToBatch(
        224, 224, batch_size,
        AnyBytesToBGRImg() >> image.BGRImgRdmCropper(224, 224)
        >> image.HFlip(0.5)
        >> image.BGRImgNormalizer(IMAGENET_BGR_MEAN, IMAGENET_BGR_STD),
        data_format=data_format)
    val_pipe = imagenet_val_pipe(batch_size, data_format=data_format)
    return train_ds >> train_pipe, val_ds >> val_pipe


def imagenet_shards(folder: str, val_fallback: str = "first"
                    ) -> tuple[list, list]:
    """(train shards, val shards) under a folder, split by file name.
    When no name contains "val", the val list is per ``val_fallback``:
    "first" (one shard: cheap validation during training, the train
    CLIs' rule) or "all" (the evaluation CLIs: accuracy over one of
    many unlabeled shards would mislead)."""
    import glob
    import os

    if val_fallback not in ("first", "all"):
        raise ValueError(f"val_fallback must be 'first'|'all', got "
                         f"{val_fallback!r}")
    shards = sorted(glob.glob(os.path.join(folder, "*")))
    train = [s for s in shards if "train" in os.path.basename(s)] or shards
    val = [s for s in shards if "val" in os.path.basename(s)] or (
        shards[:1] if val_fallback == "first" else shards)
    return train, val


def imagenet_val_pipe(batch_size: int, data_format: str = "NCHW"):
    """The center-crop evaluation pipeline (what the evaluation CLIs
    need on their own)."""
    from bigdl_tpu_torch.dataset import image
    from bigdl_tpu_torch.dataset.hadoop_seqfile import AnyBytesToBGRImg

    return image.MTLabeledBGRImgToBatch(
        224, 224, batch_size,
        AnyBytesToBGRImg() >> image.BGRImgCropper(224, 224)
        >> image.BGRImgNormalizer(IMAGENET_BGR_MEAN, IMAGENET_BGR_STD),
        data_format=data_format)


def cifar_datasets(folder: str, batch_size: int, synthetic: bool,
                   distributed: bool = False):
    """(train, validation) CIFAR-10 datasets, the reference's pipelines:
    flip and normalize for training, normalize for validation; 2048 and
    512 synthetic records (seeds 0 and 9) with ``synthetic``; the
    training records are this rank's shard with ``distributed``."""
    from bigdl_tpu_torch.dataset import cifar, image
    if synthetic:
        train_records = cifar.synthetic(2048)
        test_records = cifar.synthetic(512, seed=9)
    else:
        train_records = cifar.load(folder, train=True)
        test_records = cifar.load(folder, train=False)
    mean, std = cifar.TRAIN_MEAN, cifar.TRAIN_STD
    train_pipe = (image.HFlip(0.5) >> image.BGRImgNormalizer(mean, std)
                  >> image.BGRImgToBatch(batch_size))
    val_pipe = (image.BGRImgNormalizer(mean, std)
                >> image.BGRImgToBatch(batch_size))
    return (DataSet.array(train_records, distributed=distributed)
            >> train_pipe, DataSet.array(test_records) >> val_pipe)


def cifar_test_main(description: str, argv=None):
    """The CIFAR-10 evaluation CLI of vgg and resnet: ``Top1Accuracy`` of
    ``--model`` over the test records (512 synthetic ones with
    ``--synthetic``), printed and returned."""
    import argparse

    from bigdl_tpu_torch.dataset import cifar, image
    from bigdl_tpu_torch.nn import Module
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy

    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    records = (cifar.synthetic(512, seed=9) if args.synthetic
               else cifar.load(args.folder, train=False))
    ds = DataSet.array(records) >> (
        image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
        >> image.BGRImgToBatch(args.batchSize))
    model = Module.load(args.model, device=args.device)
    results = LocalValidator(model, ds).test([Top1Accuracy()])
    for method, result in results:
        print(f"{method} is {result}")
    return results
