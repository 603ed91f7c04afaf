"""bigdl_tpu_torch's data pipeline against the JAX package: the MT19937
permutations, the text transformers, and ``lm_corpus`` + ``lm_dataset``
batches, bit for bit for the same seed."""
import numpy as np
import pytest

from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.transformer import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.dataset.types import Sample as JaxSample
from bigdl_tpu.models.rnn.train import _SYNTH
from bigdl_tpu.models.utils import lm_corpus as jax_lm_corpus
from bigdl_tpu.models.utils import lm_dataset as jax_lm_dataset
from bigdl_tpu.utils.rng import RandomGenerator as JaxRandomGenerator

from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch, text
from bigdl_tpu_torch.models.utils import SYNTH_CORPUS, lm_corpus, lm_dataset
from bigdl_tpu_torch.utils.rng import RandomGenerator


@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_randperm_and_random_match_jax(seed):
    """The same permutations, draw after draw, as the JAX generator (its
    C backend) and as numpy's MT19937 with the same seeding, over
    several 624-word blocks."""
    jg, tg = JaxRandomGenerator(seed), RandomGenerator(seed)
    for n in (1, 2, 9, 100, 700):   # 700 draws past one 624-word block
        np.testing.assert_array_equal(tg.randperm(n), jg.randperm(n))
    assert [tg.random() for _ in range(5)] == [jg.random() for _ in range(5)]
    assert tg.random_int() == jg.random_int()
    fresh = RandomGenerator(seed)
    np.testing.assert_array_equal(
        [fresh.random() for _ in range(1500)],
        np.random.RandomState(seed).random_sample(1500))


def test_synthetic_corpus_is_the_jax_one():
    assert SYNTH_CORPUS == _SYNTH


def _batches(ds, n, train=True):
    it = ds.data(train=train)
    return [next(it) for _ in range(n)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.data.dtype == b.data.dtype and a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("packed", [False, True])
def test_lm_dataset_batches_match_jax(packed):
    """Tokens, dictionary and every batch of two shuffled epochs and the
    eval pass are identical."""
    tok, dic = lm_corpus(SYNTH_CORPUS, 20)
    jtok, jdic = jax_lm_corpus(_SYNTH, 20)
    assert tok == jtok and dic.word2index == jdic.word2index
    assert dic.vocab_size() == jdic.vocab_size()
    ds = lm_dataset(tok, dic, 12, 5, packed=packed)
    jds = jax_lm_dataset(jtok, jdic, 12, 5, packed=packed)
    assert ds.size() == jds.size()
    for _ in range(2):
        ds.shuffle()
        jds.shuffle()
        n = -(-ds.size() // 5) + 1       # an epoch and one batch more
        _assert_same_batches(_batches(ds, n), _batches(jds, n))
    _assert_same_batches(list(ds.data(train=False)),
                         list(jds.data(train=False)))


def test_text_transformers_match_jax():
    """Document packing with a stride, one-hot samples and the
    sentence-level pipeline on a corpus with unknown words."""
    raw = "Hello there, world! It's 2 a.m.  Is it? Yes. " * 3
    tokenize = text.SentenceSplitter() >> text.SentenceTokenizer() \
        >> text.SentenceBiPadding()
    jtokenize = jtext.SentenceSplitter() >> jtext.SentenceTokenizer() \
        >> jtext.SentenceBiPadding()
    tok, jtok = list(tokenize([raw])), list(jtokenize([raw]))
    assert tok == jtok
    dic, jdic = text.Dictionary(tok, 6), jtext.Dictionary(jtok, 6)
    assert [dic.get_index(w) for w in ("world", "zzz", text.SENTENCE_END)] \
        == [jdic.get_index(w) for w in ("world", "zzz", jtext.SENTENCE_END)]
    packed = list(text.DocumentPacker(dic, 5, stride=3)(iter(tok)))
    jpacked = list(jtext.DocumentPacker(jdic, 5, stride=3)(iter(jtok)))
    assert len(packed) == len(jpacked) > 3
    to_sample = text.TextToLabeledSentence(dic) >> \
        text.LabeledSentenceToSample(dic.vocab_size(), fixed_length=9,
                                     pad_label=2)
    jto_sample = jtext.TextToLabeledSentence(jdic) >> \
        jtext.LabeledSentenceToSample(jdic.vocab_size(), fixed_length=9,
                                      pad_label=2)
    for a, b in zip(list(to_sample(iter(tok))) + [
            text.LabeledSentenceToSample(7, one_hot=True).transform_one(p)
            for p in packed],
            list(jto_sample(iter(jtok))) + [
            jtext.LabeledSentenceToSample(7, one_hot=True).transform_one(p)
            for p in jpacked]):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)
    with pytest.raises(ValueError, match="pad_label"):
        text.LabeledSentenceToSample(5, pad_label=0)


def test_sample_to_batch_pads_like_jax():
    rng = np.random.RandomState(0)
    samples = [(rng.rand(n, 3).astype(np.float32),
                rng.rand(n).astype(np.float32)) for n in (4, 2, 5, 3, 1)]
    b = SampleToBatch(2, feature_padding=0.5, label_padding=-1.0,
                      fixed_length=4)
    jb = JaxSampleToBatch(2, feature_padding=0.5, label_padding=-1.0,
                          fixed_length=4)
    ds = DataSet.array([Sample(f, l) for f, l in samples]) >> b
    jds = JaxDataSet.array([JaxSample(f, l) for f, l in samples]) >> jb
    _assert_same_batches(list(ds.data(train=False)),
                         list(jds.data(train=False)))
    # distributed: one rank's shard (rank 0 of 1 with no world running)
    from bigdl_tpu_torch.dataset import DistributedDataSet
    dist_ds = DataSet.array([Sample(f, l) for f, l in samples],
                            distributed=True) >> b
    assert isinstance(dist_ds.source, DistributedDataSet)
    _assert_same_batches(list(dist_ds.data(train=False)),
                         list(jds.data(train=False)))
