"""bigdl_tpu_torch LMServingEngine on the CPU: greedy streams against the
JAX package's offline ``generate`` on the same weights, and the
scheduler's typed errors and block accounting."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.models.transformer.generate import generate as jax_generate

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (LMServingEngine, PoolExhausted,
                                     RequestExceedsPool, ServingClosed,
                                     ServingQueueFull, SpecConfig,
                                     prefill_bucket_lengths)
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.utils.params import params_from_numpy

VOCAB = 37


@pytest.fixture(scope="module")
def pair():
    kw = dict(vocab_size=VOCAB, hidden_size=32, n_head=2, n_layers=2,
              max_len=64, pos_encoding="rope")
    jm = JaxLM(attention_impl="xla", **kw).build(seed=5)
    tm = TransformerLM(device="cpu", **kw)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _wait(pred, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


@pytest.mark.parametrize("decode_attn", ["gather", "paged_kernel"])
def test_streams_token_exact_vs_jax_generate(pair, decode_attn):
    """Staggered, mixed-length requests on 2 slots with prefix sharing:
    a prompt longer than the largest bucket (chunked through the suffix
    path), two prompts sharing a 2-block head (radix hit), a 1-token
    prompt.  Every stream equals the JAX offline greedy generate."""
    jm, tm = pair
    rng = np.random.RandomState(0)
    head = rng.randint(1, VOCAB + 1, size=8)
    prompts = [rng.randint(1, VOCAB + 1, size=21),
               np.concatenate([head, rng.randint(1, VOCAB + 1, size=3)]),
               np.asarray([5]),
               np.concatenate([head, rng.randint(1, VOCAB + 1, size=6)])]
    max_new = 5
    refs = [np.asarray(jax_generate(jm, jm.params,
                                    jnp.asarray(p[None], jnp.int32),
                                    max_new))[0] for p in prompts]
    with LMServingEngine(tm, slots=2, cache_len=32, block_len=4,
                         prefill_buckets=(4, 8, 16), attention_impl="flash",
                         decode_attn=decode_attn, device="cpu") as eng:
        streams = []
        for p in prompts:
            streams.append(eng.submit(p, max_new_tokens=max_new))
            time.sleep(0.01)                       # staggered arrivals
        for s, ref in zip(streams, refs):
            np.testing.assert_array_equal(s.result(timeout=60), ref)
            assert s.ttft_s is not None and s.ttft_s >= 0
        st = eng.stats()
        assert st["decode_attn"] == decode_attn
        assert st["attention_impl"] == "flash"
        assert st["kvcache"]["prefix_cache"]["hits"] >= 1
        assert st["metrics"]["completed"] == len(prompts)
        assert _wait(lambda: eng.pool.free_count
                     + eng.radix.stats()["nodes"] == eng.pool.capacity)


def test_eos_frees_slot_and_streams_tokens(pair):
    _, tm = pair
    with LMServingEngine(tm, slots=1, cache_len=32, block_len=4,
                         device="cpu") as eng:
        p = np.asarray([3, 9, 14, 2])
        full = eng.generate(p, max_new_tokens=8, timeout=60)
        gen = full[len(p):]
        eos = int(gen[2])
        cut = eng.submit(p, max_new_tokens=8, eos_id=eos)
        toks = list(cut.tokens(timeout=60))
        stop = list(gen).index(eos) + 1
        assert toks == list(gen[:stop])
        # the slot came back: another request runs on the single slot
        assert len(eng.generate([4, 4], max_new_tokens=2, timeout=60)) == 4
        assert _wait(lambda: eng.stats()["active"] == 0)


def test_warmup_writes_only_scratch_and_auto_picks_plain_on_cpu(pair):
    _, tm = pair
    with LMServingEngine(tm, slots=2, cache_len=32, block_len=4,
                         prefill_buckets=(4, 8, 16), device="cpu") as eng:
        assert eng.attention_impl == "xla" and eng.decode_attn == "gather"
        assert eng.warmup() == 3
        assert eng.pool.free_count == eng.pool.capacity
        assert not eng.pool.k[:, 1:].any() and not eng.pool.v[:, 1:].any()
        assert eng.pool.k[:, 0].any()            # scratch took the rows
        out = eng.generate([3, 1, 4, 1, 5], max_new_tokens=3, timeout=60)
        assert out.shape == (8,)


def test_typed_rejections(pair):
    _, tm = pair
    with LMServingEngine(tm, slots=1, cache_len=32, block_len=4,
                         num_blocks=4, max_queue=1, device="cpu") as eng:
        with pytest.raises(RequestExceedsPool):
            eng.submit(np.arange(1, 12), max_new_tokens=4)  # 4 > 3 blocks
        with pytest.raises(ValueError, match="cache_len"):
            eng.submit(np.arange(1, 30), max_new_tokens=8)
        assert eng.stats()["metrics"]["rejected"] == 1
    eng.close()
    with pytest.raises(ServingClosed):
        eng.submit([1, 2], max_new_tokens=4)
    with LMServingEngine(tm, slots=1, cache_len=32, max_queue=1,
                         device="cpu") as eng:
        with eng._cv:                      # hold the worker off the queue
            eng._queue.append(object())
            with pytest.raises(ServingQueueFull):
                eng.submit([1, 2], max_new_tokens=4)
            eng._queue.clear()


def test_unported_options_raise(pair):
    _, tm = pair
    from bigdl_tpu_torch.serving import MeshSlice, PlacementError
    with pytest.raises(PlacementError, match="not by this process"):
        LMServingEngine(tm, device="cpu", placement=MeshSlice(
            1, ["cpu"], 1, (1,), per_rank=True))
    # ported since disaggregated serving: a prefill replica (migrate=)
    with LMServingEngine(tm, cache_len=32, device="cpu",
                         migrate=print) as eng:
        assert eng.phase == "prefill"
    # ported since quantization: int8 KV arenas (through the gather), the
    # default drafter (the target's int8 clone) and the integer spec=k
    with LMServingEngine(tm, cache_len=32, device="cpu",
                         kv_quant="int8") as eng:
        assert eng.pool.k.dtype == torch.int8 and eng.decode_attn == "gather"
    with LMServingEngine(tm, cache_len=32, device="cpu",
                         spec=SpecConfig(k=2)) as eng:
        assert eng.draft.dtype_tag == "int8"
        assert eng.draft.compute_mode == "dequant"
    with LMServingEngine(tm, cache_len=32, device="cpu", spec=2) as eng:
        assert isinstance(eng.spec, SpecConfig) and eng.spec.k == 2
        assert eng.draft.dtype_tag == "int8"
    with pytest.raises(TypeError, match="SpecConfig"):
        LMServingEngine(tm, device="cpu", spec="2")
    # ported since the request lifecycle and the host KV tier: kvtier=,
    # submit(deadline_s=) and LMStream.cancel()
    from bigdl_tpu_torch.serving.kvtier import HostBlockStore
    with LMServingEngine(tm, cache_len=32, device="cpu",
                         kvtier=HostBlockStore(host_bytes=1 << 20)) as eng:
        assert eng.radix.on_evict == eng._demote_block
        s = eng.submit([1, 2], max_new_tokens=1, deadline_s=60.0)
        s.result(timeout=60)
        assert s.cancel() is False and s.truncation is None
    with pytest.raises(ValueError, match="model lives"):
        other = TransformerLM(vocab_size=VOCAB, hidden_size=32, n_head=2,
                              n_layers=2, max_len=64, device="cpu")
        other.device = torch.device("meta")
        other.params = tm.params
        LMServingEngine(other, device="cpu")


def test_block_pool_and_radix_refcounts():
    pool = BlockPool(n_layers=1, n_heads=1, head_dim=2, block_len=2,
                     num_blocks=5)
    assert pool.capacity == 4 and pool.k.shape == (1, 5, 1, 2, 2)
    a = pool.alloc(3)
    assert a == [1, 2, 3] and pool.free_count == 1
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    radix = RadixCache(pool)
    toks = np.asarray([1, 2, 3, 4, 5])
    assert radix.insert(toks[:4], a[:2]) == 2
    pool.release(a)                        # the sequence finishes
    assert pool.refcount(1) == 1 and pool.free_count == 2
    hit = radix.match(toks)                # (5 - 1) // 2 = 2 blocks
    assert hit == [1, 2] and pool.refcount(1) == 2
    pool.release(hit)
    assert radix.evict(5) == 2 and pool.free_count == 4
    with pytest.raises(ValueError):
        pool.release([1])
    assert prefill_bucket_lengths(48) == (8, 16, 32, 48)
