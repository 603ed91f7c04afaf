"""bigdl_tpu_torch's autotune cache, attention dispatch and blockwise core
against the JAX package on the CPU (mirrors
``tests/test_autotune_attention.py``, ``tests/test_qcompute.py``'s duel
test and the blockwise parts of the attention tests).

- The winners and the three lookups are the reference's on the same
  rows and docs, exactly.
- The port reads only its own cache (``BIGDL_TPU_TORCH_TUNE_CACHE``),
  only docs it wrote, for its platform and device kind: a verdict the
  JAX package wrote never steers it.
- The port's CPU "flash" is its plain version, as the reference's is
  interpret mode; sweeps run at D 8, T 32.
- The blockwise core matches the reference's outputs (rtol 1e-5, atol
  1e-6) and gradients (within 1e-5 of each leaf's max |g|).

Every test points both packages' caches at tmp files and leaves the
repository's ``TUNE_ATTN.json`` byte for byte as it was, with no
``TUNE_CUDA.json`` beside it.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import blockwise_attention as jax_blockwise
from bigdl_tpu.ops import autotune as jax_tune
from bigdl_tpu.serving import LMServingEngine as JaxEngine

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.transformer.generate import generate
from bigdl_tpu_torch.nn.attention import (blockwise_attention,
                                          dot_product_attention)
from bigdl_tpu_torch.ops import (FLASH_TILES, autotune, flash_attention,
                                 flash_attention_with_lse, flash_tiles,
                                 resolve_attention_plan, use_flash_auto)
from bigdl_tpu_torch.quant.kernels import resolve_compute
from bigdl_tpu_torch.quant.qtensor import quantize_array
from bigdl_tpu_torch.serving import LMServingEngine
from bigdl_tpu_torch.utils.file_io import build_module, module_spec
from bigdl_tpu_torch.utils.params import params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
QUIET = dict(log=lambda *_: None)
#: tiny CPU sweep: the plain version at T 32 is milliseconds
TINY = dict(head_dim=8, dtype="float32", causal=True, batch=1, heads=2,
            device="cpu", **QUIET)
FWD = dict(rtol=1e-5, atol=1e-6)


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    ref_cache = REPO / "TUNE_ATTN.json"
    before = _sha(ref_cache)
    monkeypatch.setenv("BIGDL_TPU_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("BIGDL_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "port.json"))
    jax_tune.clear_cache()
    autotune.clear_cache()
    yield
    jax_tune.clear_cache()
    autotune.clear_cache()
    assert _sha(ref_cache) == before
    assert not (REPO / "TUNE_CUDA.json").exists()


def _port_doc(winners, **kw):
    return dict({"producer": autotune.PRODUCER, "platform": "cpu",
                 "device_kind": "cpu", "winners": winners}, **kw)


def _fake_cache(winners, **kw):
    path = pathlib.Path(os.environ["BIGDL_TPU_TORCH_TUNE_CACHE"])
    path.write_text(json.dumps(_port_doc(winners, **kw)))
    autotune.clear_cache()
    return path


# --------------------------------------------------------------------------- #
# winners and lookups: the reference's, exactly                               #
# --------------------------------------------------------------------------- #

def _att(impl, t, bq, bk, step=None, **kw):
    row = dict(dict(kind="train_step", impl=impl, seq_len=t, head_dim=64,
                    dtype="float32", causal=True, batch=8, heads=12,
                    iters=3, block_q=bq, block_k=bk), **kw)
    if step is not None:
        row["step_s"] = step
    return row


def _paged(impl, step=None, bl=16, dtype="float32", **kw):
    row = dict(kind="paged_decode", impl=impl, slots=8, heads=12,
               head_dim=64, cache_len=1024, block_len=bl, dtype=dtype,
               iters=20, **kw)
    if step is not None:
        row["step_s"] = step
    return row


def _q(impl, m, k, n, step=None):
    row = dict(kind="qcompute", impl=impl, m=m, k=k, n=n, iters=20)
    if step is not None:
        row["step_s"] = step
    return row


ROW_SETS = {
    "flash_tiles_and_plain": [
        _att("flash", 1024, 64, 32, 0.004), _att("flash", 1024, 64, 64,
                                                 0.003),
        _att("naive_xla", 1024, 0, 0, 0.005),
        _att("flash", 512, 64, 32, 0.002), _att("naive_xla", 512, 0, 0,
                                                0.001),
        _att("flash", 512, 64, 64, 0.0021),
        _att("flash", 2048, 64, 32, 0.01, dtype="bfloat16")],
    "plain_capacity_error": [
        _att("flash", 4096, 64, 32, 0.02),
        _att("naive_xla", 4096, 0, 0,
             error="OutOfMemoryError: CUDA out of memory. Tried to "
                   "allocate 3.00 GiB"),
        _att("flash", 8192, 64, 32, error="RuntimeError: boom"),
        _att("naive_xla", 8192, 0, 0, 0.5)],
    "paged": [_paged("paged_kernel", 1.5e-05), _paged("dense_gather",
                                                      1.4e-04),
              _paged("paged_kernel", 2e-05, bl=32),
              _paged("dense_gather", error="RuntimeError: x", bl=32),
              _paged("paged_kernel", 3e-05, dtype="bfloat16"),
              _paged("dense_gather", 3e-05, dtype="bfloat16")],
    "qcompute_with_tie": [
        _q("int8_compute", 8, 768, 768, 3e-05),
        _q("dequant_bf16", 8, 768, 768, 3e-05),
        _q("int8_compute", 256, 768, 3072, 2e-05),
        _q("dequant_bf16", 256, 768, 3072, 4e-05),
        _q("int8_compute", 8, 3072, 768),
        _q("dequant_bf16", 8, 3072, 768, 1e-05)],
    "missing_step_s": [
        _att("flash", 64, 64, 32), _att("naive_xla", 64, 0, 0),
        _paged("paged_kernel"), _q("int8_compute", 4, 32, 48),
        "not a row", {"kind": "unknown"}],
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_winner_parity(name):
    rows = ROW_SETS[name]
    assert autotune._recompute_winners(rows) == \
        jax_tune._recompute_winners(rows)


def test_winner_parity_all_rows_together():
    rows = [r for name in sorted(ROW_SETS) for r in ROW_SETS[name]]
    want = jax_tune._recompute_winners(rows)
    assert autotune._recompute_winners(rows) == want
    # the tie keeps the baseline in both
    assert want[jax_tune.qcompute_key(8, 768, 768)]["use_int8"] is False


LOOKUP_KEYS = {
    "attention": [(t, d, dt, c) for t in (64, 512, 1024, 2048, 4096, 8192)
                  for d in (8, 64) for dt in ("float32", "bfloat16")
                  for c in (True, False)],
    "paged": [(d, bl, dt) for d in (64, 128) for bl in (16, 32)
              for dt in ("float32", "bfloat16")],
    "qcompute": [(m, k, n) for m in (4, 8, 40, 256, 999)
                 for k, n in ((768, 768), (768, 3072), (3072, 768),
                              (32, 48), (768, 769))],
}


@pytest.mark.parametrize("kind", ["TPU v9 or NVIDIA H100 80GB HBM3",
                                  "foreign"])
def test_lookup_parity(tmp_path, monkeypatch, kind):
    """One doc, each package's device kind (and the port's platform)
    patched: every lookup agrees; on a foreign device kind both give
    None."""
    rows = [r for name in sorted(ROW_SETS) for r in ROW_SETS[name]]
    doc_kind = "TPU v9 or NVIDIA H100 80GB HBM3"
    doc = _port_doc(jax_tune._recompute_winners(rows), device_kind=doc_kind,
                    platform="gpu")
    path = str(tmp_path / "doc.json")
    pathlib.Path(path).write_text(json.dumps(doc))
    monkeypatch.setattr(jax_tune, "_device_kind", lambda: kind)
    monkeypatch.setattr(autotune, "_device_kind", lambda *a, **k: kind)
    monkeypatch.setattr(autotune, "_platform", lambda *a, **k: "gpu")
    seen = 0
    for t, d, dt, c in LOOKUP_KEYS["attention"]:
        want = jax_tune.lookup(t, d, dt, c, path=path)
        assert autotune.lookup(t, d, dt, c, path=path) == want
        seen += want is not None
    for d, bl, dt in LOOKUP_KEYS["paged"]:
        want = jax_tune.lookup_paged(d, bl, dt, path=path)
        assert autotune.lookup_paged(d, bl, dt, path=path) == want
        seen += want is not None
    for m, k, n in LOOKUP_KEYS["qcompute"]:
        want = jax_tune.lookup_qcompute(m, k, n, path=path)
        assert autotune.lookup_qcompute(m, k, n, path=path) == want
        seen += want is not None
    # the largest-m fallback: (999, 768, 3072) takes m 256's verdict
    if kind == doc_kind:
        assert autotune.lookup_qcompute(999, 768, 3072, path=path) == "int8"
        assert seen >= 10
    else:
        assert seen == 0


def test_port_ignores_wrong_platform_and_reference_docs(tmp_path,
                                                        monkeypatch):
    key = autotune.attention_key(32, 8, "float32", True)
    # the right device kind on the wrong platform
    path = _fake_cache({key: {"use_flash": True, "block_q": 64,
                              "block_k": 64}}, platform="gpu")
    assert autotune.lookup(32, 8, "float32", True, device="cpu") is None
    # a doc the JAX package wrote on the CPU (platform and device kind
    # "cpu" too), at the port's own cache path
    jax_doc = jax_tune.autotune_qcompute([(4, 32, 48)], iters=1,
                                         path=str(path), **QUIET)
    assert jax_doc["platform"] == "cpu" and jax_doc["device_kind"] == "cpu"
    assert jax_tune.lookup_qcompute(4, 32, 48, path=str(path)) is not None
    autotune.clear_cache()
    assert autotune.lookup_qcompute(4, 32, 48, device="cpu") is None
    qw = quantize_array(np.ones((32, 48), np.float32), (0,), compute="auto")
    assert resolve_compute(qw, (4, 32)) == "dequant"
    # and the reference's own cache variable is never read
    monkeypatch.setenv("BIGDL_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "missing.json"))
    monkeypatch.setenv("BIGDL_TPU_TUNE_CACHE", str(path))
    autotune.clear_cache()
    assert autotune.lookup_qcompute(4, 32, 48, device="cpu") is None
    assert autotune.cache_path() == str(tmp_path / "missing.json")


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_TORCH_TUNE_CACHE")
    assert autotune.cache_path() == str(REPO / "TUNE_CUDA.json")


def test_grid_is_the_kernels_tiles():
    assert autotune.parse_grid("64:32, 64:128") == ((64, 32), (64, 128))
    for (dt, d), tiles in FLASH_TILES.items():
        assert set(autotune.default_grid(dt, d)) == set(tiles)
        assert all(bq == 64 for bq, _ in tiles) and len(tiles) >= 2
    assert autotune.default_grid(torch.float32, 8) == ((64, 32), (64, 64))


# --------------------------------------------------------------------------- #
# sweep and cache (mirrors of tests/test_autotune_attention.py)                #
# --------------------------------------------------------------------------- #

def test_sweep_writes_winners_and_lookup_roundtrip(tmp_path):
    path = str(tmp_path / "tune.json")
    doc = autotune.autotune_attention([32], iters=1, path=path, **TINY)
    assert doc["complete"] is True
    assert (doc["platform"], doc["device_kind"]) == ("cpu", "cpu")
    assert doc["producer"] == "bigdl_tpu_torch"
    # 2 tiles + 1 plain baseline, every row measured
    assert len(doc["rows"]) == 3
    assert all("step_s" in r for r in doc["rows"])
    key = autotune.attention_key(32, 8, "float32", True)
    w = doc["winners"][key]
    assert w["use_flash"] in (True, False)
    assert (w["block_q"], w["block_k"]) in autotune.default_grid(
        "float32", 8)
    e = autotune.lookup(32, 8, "float32", True, path=path, device="cpu")
    assert e is not None and e.use_flash == w["use_flash"]
    assert (e.block_q, e.block_k) == (w["block_q"], w["block_k"])
    assert autotune.lookup(64, 8, "float32", True, path=path,
                           device="cpu") is None


def test_resume_reuses_only_identity_matched_rows(tmp_path):
    path = str(tmp_path / "tune.json")
    autotune.autotune_attention([32], iters=1, path=path, **TINY)
    doc2 = autotune.autotune_attention([32], iters=1, path=path, **TINY)
    assert all(r.get("reused_from_previous_run") for r in doc2["rows"])
    doc3 = autotune.autotune_attention([32], iters=2, path=path, **TINY)
    assert not any(r.get("reused_from_previous_run") for r in doc3["rows"])


def test_certified_doc_survives_allreuse_and_killed_reruns(tmp_path,
                                                           monkeypatch):
    path = str(tmp_path / "tune.json")
    doc = autotune.autotune_attention([32], iters=1, path=path, **TINY)
    assert doc["complete"] is True
    certified = open(path, "rb").read()
    doc2 = autotune.autotune_attention([32], iters=1, path=path, **TINY)
    assert doc2["complete"] is True
    assert all(r.get("reused_from_previous_run") for r in doc2["rows"])
    assert open(path, "rb").read() == certified
    fa_mod = sys.modules["bigdl_tpu_torch.ops.flash_attention"]

    def _killed(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(fa_mod, "flash_attention", _killed)
    wider = dict(TINY, grid=((64, 32), (64, 64), (64, 128)))
    with pytest.raises(KeyboardInterrupt):
        autotune.autotune_attention([32], iters=1, path=path, **wider)
    assert open(path, "rb").read() == certified


def test_sticky_cuda_error_propagates_and_is_not_recorded(tmp_path,
                                                          monkeypatch):
    """A failed candidate is a recorded row; a sticky CUDA error is
    not: it propagates and no candidate follows."""
    path = str(tmp_path / "tune.json")
    fa_mod = sys.modules["bigdl_tpu_torch.ops.flash_attention"]
    calls = []

    def _fails(*a, **k):
        calls.append(k.get("block_k"))
        raise RuntimeError("bigdl_flash_fwd failed to launch: CUDA error "
                           "1 (invalid argument)")

    monkeypatch.setattr(fa_mod, "flash_attention", _fails)
    doc = autotune.autotune_attention([32], iters=1, path=path, **TINY)
    flash = [r for r in doc["rows"] if r["impl"] == "flash"]
    assert [("error" in r, "step_s" in r) for r in flash] == \
        [(True, False)] * 2
    assert doc["winners"][autotune.attention_key(32, 8, "float32", True)][
        "use_flash"] is None

    def _sticky(*a, **k):
        calls.append("sticky")
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(fa_mod, "flash_attention", _sticky)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        autotune.autotune_attention([64], iters=1, path=path, **TINY)
    assert calls.count("sticky") == 1
    rows = json.load(open(path))["rows"]
    assert not any("illegal" in (r.get("error") or "") for r in rows)


def test_other_config_rows_accumulate_across_sweeps(tmp_path):
    path = str(tmp_path / "tune.json")
    autotune.autotune_attention([32], iters=1, path=path, **TINY)
    autotune.autotune_paged_decode(slots=2, heads=2, head_dim=8,
                                   cache_len=16, block_len=4,
                                   dtype="float32", iters=1, path=path,
                                   device="cpu", **QUIET)
    doc = json.load(open(path))
    assert {r["kind"] for r in doc["rows"]} == {"train_step",
                                                 "paged_decode"}
    assert autotune.attention_key(32, 8, "float32", True) in doc["winners"]
    pk = autotune.paged_key(8, 4, "float32")
    assert doc["winners"][pk]["use_kernel"] in (True, False)
    e = autotune.lookup_paged(8, 4, "float32", path=path, device="cpu")
    assert e is not None and e.use_kernel == doc["winners"][pk]["use_kernel"]


def test_lookup_ignores_other_device_kind(tmp_path):
    key = autotune.attention_key(64, 8, "float32", True)
    path = tmp_path / "tune.json"
    path.write_text(json.dumps(_port_doc({key: {"use_flash": False}},
                                         device_kind="NVIDIA H999")))
    assert autotune.lookup(64, 8, "float32", True, path=str(path),
                           device="cpu") is None


# --------------------------------------------------------------------------- #
# crossover dispatch                                                          #
# --------------------------------------------------------------------------- #

def test_plan_tuned_xla_reroute():
    key = autotune.attention_key(64, 8, "float32", True)
    _fake_cache({key: {"use_flash": False}})
    plan = resolve_attention_plan(64, 8, torch.float32, True, device="cpu")
    assert (plan.impl, plan.source) == ("xla", "tuned")
    assert not use_flash_auto(64, 8, torch.float32, True, device="cpu")


CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def card_kind(monkeypatch):
    """A lookup for "cuda" answers as if that card were attached."""
    real = autotune._device_kind
    monkeypatch.setattr(autotune, "_device_kind", lambda device=None: (
        CARD if autotune._device(device).type == "cuda" else real(device)))


@pytest.mark.parametrize("winner, tile", [
    ({"use_flash": False, "block_q": 64, "block_k": 64}, (64, 64)),
    ({"use_flash": False}, (64, 32)),
    ({"use_flash": True, "block_q": 64, "block_k": 64}, (64, 64))])
def test_card_verdict_picks_the_tile_and_keeps_the_kernel(card_kind, winner,
                                                          tile):
    """On a CUDA device a verdict names the kernel's tile only: a plain
    core that won the sweep never takes a call from the kernel there."""
    key = autotune.attention_key(64, 64, "float32", True)
    _fake_cache({key: winner}, platform="gpu", device_kind=CARD)
    assert autotune.lookup(64, 64, "float32", True, device="cuda") \
        .use_flash is winner["use_flash"]
    assert resolve_attention_plan(64, 64, torch.float32, True,
                                  device="cuda") == ("flash", *tile, "tuned")
    assert use_flash_auto(64, 64, torch.float32, True, device="cuda")
    mha = tnn.MultiHeadAttention(128, 2, causal=True)
    assert mha.resolve_use_flash("cuda", seq_len=64, dtype=torch.float32)
    # the doc is the card's: on the CPU nothing is tuned
    assert resolve_attention_plan(64, 64, torch.float32, True,
                                  device="cpu") == ("flash", 64, 32,
                                                    "default")


def test_card_stale_tile_verdict_raises(card_kind):
    key = autotune.attention_key(64, 64, "float32", True)
    path = _fake_cache({key: {"use_flash": False, "block_q": 64,
                              "block_k": 128}},
                       platform="gpu", device_kind=CARD)
    with pytest.raises(ValueError, match="stale") as err:
        resolve_attention_plan(64, 64, torch.float32, True, device="cuda")
    assert str(path) in str(err.value) and "(64, 128)" in str(err.value)


def test_plan_tuned_blocks():
    key = autotune.attention_key(64, 8, "float32", True)
    _fake_cache({key: {"use_flash": True, "block_q": 64, "block_k": 64}})
    plan = resolve_attention_plan(64, 8, torch.float32, True, device="cpu")
    assert plan == ("flash", 64, 64, "tuned")


def test_plan_explicit_blocks_pin_the_kernel():
    key = autotune.attention_key(64, 8, "float32", True)
    _fake_cache({key: {"use_flash": False}})
    plan = resolve_attention_plan(64, 8, torch.float32, True,
                                  block_q=64, block_k=64, device="cpu")
    assert plan == ("flash", 64, 64, "pinned")


def test_plan_default_without_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "missing.json"))
    autotune.clear_cache()
    for dt, d in FLASH_TILES:
        plan = resolve_attention_plan(64, d, dt, True, device="cpu")
        assert plan == ("flash", *FLASH_TILES[(dt, d)][0], "default")
    assert resolve_attention_plan(64, 8, torch.float32, True,
                                  device="cpu") == ("flash", 64, 32,
                                                    "default")


def _qkv(t=32, d=8, seed=0, tq=None):
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(1, 2, tq or t, d).astype(np.float32))
    k, v = (torch.tensor(rng.randn(1, 2, t, d).astype(np.float32))
            for _ in range(2))
    return q, k, v


def test_flash_attention_tuned_reroute_matches_plain_core():
    key = autotune.attention_key(32, 8, "float32", True)
    _fake_cache({key: {"use_flash": False}})
    q, k, v = _qkv()
    out = flash_attention(q, k, v, causal=True)
    ref = dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_stale_tile_verdict_raises():
    key = autotune.attention_key(32, 8, "float32", True)
    path = _fake_cache({key: {"use_flash": True, "block_q": 64,
                              "block_k": 48}})
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="stale") as err:
        flash_attention(q, k, v, causal=True)
    assert str(path) in str(err.value) and "(64, 48)" in str(err.value)
    mha = tnn.MultiHeadAttention(16, 2, causal=True)
    with pytest.raises(ValueError, match="stale"):
        resolve_attention_plan(32, 8, "float32", True, device="cpu")
    assert mha.resolve_use_flash("cpu", seq_len=32, dtype=torch.float32)


def test_pair_outside_the_tiles_raises():
    q, k, v = _qkv()
    for bq, bk in ((64, 48), (32, 32), (128, 64)):
        with pytest.raises(ValueError, match="takes"):
            flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        with pytest.raises(ValueError, match="takes"):
            flash_attention_with_lse(q, k, v, causal=True, block_q=bq,
                                     block_k=bk)
    assert flash_tiles(torch.bfloat16, 128) == FLASH_TILES[("bfloat16", 128)]
    # a pinned tile the kernel takes runs (the plain version on the CPU)
    o = flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(
        o.numpy(), dot_product_attention(q, k, v, causal=True).numpy(),
        rtol=1e-5, atol=1e-6)


def test_use_flash_auto_reads_verdicts_per_length_and_memoizes():
    key32 = autotune.attention_key(32, 8, "float32", True)
    path = _fake_cache({key32: {"use_flash": True, "block_q": 64,
                                "block_k": 32}})
    mha = tnn.MultiHeadAttention(16, 2, causal=True)
    # a verdict for 32 routes 32 only; 16 keeps the static rule (CPU)
    assert mha.resolve_use_flash("cpu", seq_len=32, dtype=torch.float32)
    assert not mha.resolve_use_flash("cpu", seq_len=16,
                                     dtype=torch.float32)
    assert not mha.resolve_use_flash("cpu", "xla", seq_len=32,
                                     dtype=torch.float32)
    # a pinned block size pins the blockwise core, whatever the cache
    pinned = tnn.MultiHeadAttention(16, 2, causal=True, block_size=4)
    assert not pinned.resolve_use_flash("cpu", seq_len=32,
                                        dtype=torch.float32)
    # memoized until clear_cache()
    path.write_text(json.dumps(_port_doc({key32: {"use_flash": False}})))
    assert use_flash_auto(32, 8, torch.float32, True, device="cpu")
    autotune.clear_cache()
    assert not use_flash_auto(32, 8, torch.float32, True, device="cpu")
    # the static rule without a verdict
    assert use_flash_auto(32, 8, torch.float32, True, device="cuda")
    assert not use_flash_auto(32, 8, torch.float32, True, device="cpu")


def test_qcompute_duel_verdict_drives_auto():
    doc = autotune.autotune_qcompute([(4, 32, 48)], iters=1, device="cpu",
                                     **QUIET)
    assert doc["complete"] is True
    key = autotune.qcompute_key(4, 32, 48)
    entry = doc["winners"][key]
    assert entry["use_int8"] in (True, False)
    verdict = autotune.lookup_qcompute(4, 32, 48, device="cpu")
    assert verdict == ("int8" if entry["use_int8"] else "dequant")
    assert autotune.lookup_qcompute(999, 32, 48, device="cpu") == verdict
    assert autotune.lookup_qcompute(4, 32, 49, device="cpu") is None
    rng = np.random.RandomState(0)
    qw = quantize_array(rng.randn(32, 48).astype(np.float32), (0,),
                        compute="auto")
    assert resolve_compute(qw, (4, 32)) == verdict
    qw_miss = quantize_array(rng.randn(32, 49).astype(np.float32), (0,),
                             compute="auto")
    assert resolve_compute(qw_miss, (4, 32)) == "dequant"


@pytest.mark.parametrize("use_int8", [True, False])
def test_qcompute_auto_follows_a_written_verdict(use_int8):
    _fake_cache({autotune.qcompute_key(8, 32, 48): {
        "qcompute": True, "m": 8, "k": 32, "n": 48, "use_int8": use_int8}})
    rng = np.random.RandomState(1)
    qw = quantize_array(rng.randn(32, 48).astype(np.float32), (0,),
                        compute="auto")
    want = "int8" if use_int8 else "dequant"
    assert resolve_compute(qw, (2, 4, 32)) == want   # m 8, an exact key
    assert resolve_compute(qw, (3, 32)) == want      # the largest-m rule


# --------------------------------------------------------------------------- #
# the LM engine: decode_attn and the prefill buckets                          #
# --------------------------------------------------------------------------- #

LM_KW = dict(vocab_size=37, hidden_size=32, n_head=2, n_layers=2,
             max_len=64, pos_encoding="learned")
ENGINE_KW = dict(slots=2, cache_len=32, block_len=4,
                 prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(attention_impl="xla", **LM_KW).build(seed=5)
    tm = TransformerLM(device="cpu", **LM_KW)
    tm.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _both_caches(winners):
    """One doc both packages read: the port's stamp, the JAX package's
    device kind (on the CPU both are "cpu")."""
    doc = _port_doc(winners, device_kind=jax.devices()[0].device_kind)
    text = json.dumps(doc)
    for var in ("BIGDL_TPU_TUNE_CACHE", "BIGDL_TPU_TORCH_TUNE_CACHE"):
        pathlib.Path(os.environ[var]).write_text(text)
    jax_tune.clear_cache()
    autotune.clear_cache()


@pytest.mark.parametrize("use_kernel", [True, False, None])
def test_engine_decode_attn_auto_is_the_references(pair, use_kernel):
    jm, tm = pair
    winners = {}
    if use_kernel is not None:
        winners[autotune.paged_key(16, 4, "float32")] = {
            "head_dim": 16, "block_len": 4, "dtype": "float32",
            "use_kernel": use_kernel}
    _both_caches(winners)
    rng = np.random.RandomState(use_kernel is None)
    prompts = [rng.randint(1, 38, size=n) for n in (5, 11)]
    with JaxEngine(jm, decode_attn="auto", max_new_tokens=4,
                   **ENGINE_KW) as je:
        want_attn = je.decode_attn
        want = [je.submit(p).result(timeout=120) for p in prompts]
    with LMServingEngine(tm, decode_attn="auto", max_new_tokens=4,
                         device="cpu", **ENGINE_KW) as te:
        assert te.decode_attn == want_attn == (
            "paged_kernel" if use_kernel else "gather")
        got = [te.submit(p).result(timeout=120) for p in prompts]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_engine_resolves_each_prefill_bucket_once(pair):
    """A verdict for one bucket length routes that bucket only; the
    streams do not change (the plain core and the CPU flash are the same
    arithmetic)."""
    _, tm = pair
    key = autotune.attention_key(16, 16, "float32", True)
    _fake_cache({key: {"use_flash": True, "block_q": 64, "block_k": 64}})
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 38, size=n) for n in (5, 13)]
    with LMServingEngine(tm, attention_impl="auto", max_new_tokens=4,
                         device="cpu", **ENGINE_KW) as te:
        assert te.stats()["prefill_attention"] == {
            "8": "xla", "16": "flash 64x64"}
        assert te.attention_impl == "flash"
        got = [te.submit(p).result(timeout=120) for p in prompts]
    with LMServingEngine(tm, attention_impl="xla", max_new_tokens=4,
                         device="cpu", **ENGINE_KW) as te:
        assert te.stats()["prefill_attention"] == {"8": "xla", "16": "xla"}
        want = [te.submit(p).result(timeout=120) for p in prompts]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # explicit "flash" keeps the default tile whatever the cache says
    with LMServingEngine(tm, attention_impl="flash", max_new_tokens=4,
                         device="cpu", **ENGINE_KW) as te:
        assert te.stats()["prefill_attention"] == {
            "8": "flash 64x32", "16": "flash 64x32"}


def test_generate_resolves_per_prefill_length(pair, monkeypatch):
    _, tm = pair
    key = autotune.attention_key(7, 16, "float32", True)
    _fake_cache({key: {"use_flash": True, "block_q": 64, "block_k": 64}})
    tm_auto = TransformerLM(device="cpu", attention_impl="auto", **LM_KW)
    tm_xla = TransformerLM(device="cpu", attention_impl="xla", **LM_KW)
    tm_auto.params = tm_xla.params = tm.params
    seen = []
    gen_mod = sys.modules["bigdl_tpu_torch.models.transformer.generate"]
    real = gen_mod.flash_attention

    def spy(*a, **k):
        seen.append((a[0].shape[-2], k.get("block_k")))
        return real(*a, **k)

    monkeypatch.setattr(gen_mod, "flash_attention", spy)
    for t in (7, 9):
        ids = torch.tensor(np.arange(1, t + 1)[None])
        out = generate(tm_auto, tm_auto.params, ids, 2, device="cpu")
        want = generate(tm_xla, tm_xla.params, ids, 2, device="cpu")
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    # the 7-token prompt's prefill ran flash (a verdict), the 9-token
    # one plain (the CPU's static rule)
    assert seen and {s for s, _ in seen} == {7}


# --------------------------------------------------------------------------- #
# the blockwise core                                                          #
# --------------------------------------------------------------------------- #

BLOCKWISE = [(bs, t, t, causal) for bs in (4, 7, 16) for t in (16, 13)
             for causal in (True, False)] + [
    (4, 5, 13, True), (4, 9, 16, False), (7, 13, 7, True), (16, 3, 12, True)]


def _blockwise_inputs(tq, tk, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(2, 3, tq, 8).astype(np.float32)
    k = rng.randn(2, 3, tk, 8).astype(np.float32)
    v = rng.randn(2, 3, tk, 8).astype(np.float32)
    cot = rng.randn(2, 3, tq, 8).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("bs,tq,tk,causal", BLOCKWISE)
def test_blockwise_matches_reference(bs, tq, tk, causal):
    q, k, v, cot = _blockwise_inputs(tq, tk, bs * 100 + tq + tk)

    def ref_loss(q, k, v):
        o = jax_blockwise(q, k, v, block_size=bs, causal=causal)
        return jnp.sum(o * cot), o

    (_, o_ref), g_ref = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = blockwise_attention(*leaves, block_size=bs, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **FWD)
    grads = torch.autograd.grad((o * torch.tensor(cot)).sum(), leaves)
    for got, want in zip(grads, g_ref):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), 1e-30)


def test_blockwise_mha_from_the_reference_seed():
    def make(n):
        return n.MultiHeadAttention(16, 2, causal=True, block_size=4)

    a, b = make(jnn).build(3), make(tnn).build(3, device="cpu")
    x = np.random.RandomState(0).randn(2, 13, 16).astype(np.float32)
    want = np.asarray(a.evaluate().forward(x))
    got = b.evaluate().forward(x)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    # the blockwise core, not the plain one, ran
    assert b.block_size == 4 and not b.resolve_use_flash(
        "cpu", seq_len=13, dtype=torch.float32)


def test_blockwise_path_refuses_segment_ids():
    seg = np.zeros((2, 13), np.int32)
    x = np.random.RandomState(1).randn(2, 13, 16).astype(np.float32)
    ja = jnn.MultiHeadAttention(16, 2, causal=True, block_size=4).build(0)
    tb = tnn.MultiHeadAttention(16, 2, causal=True, block_size=4).build(
        0, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        ja.f(ja.params, jnp.asarray(x), segment_ids=jnp.asarray(seg))
    with pytest.raises(ValueError, match="block_size"):
        tb.f(tb.params, torch.tensor(x), segment_ids=torch.tensor(seg))


def test_pinned_block_size_with_flash_pins_the_tile(monkeypatch):
    """"flash" with a block size calls the kernel at block_q = block_k =
    block_size: the kernel has no 4x4 tile, so 4 raises; float32 takes
    64x64, so 64 runs (the plain version on the CPU) at that tile."""
    q, k, v = _qkv()
    mha = tnn.MultiHeadAttention(16, 2, causal=True, block_size=4,
                                 attention_impl="flash")
    with pytest.raises(ValueError, match="takes"):
        mha.attend(q, k, v)
    fa_mod = sys.modules["bigdl_tpu_torch.ops.flash_attention"]
    tiles = []
    real = fa_mod._FlashLse.apply

    def spy(*a):
        tiles.append(a[-1])
        return real(*a)

    monkeypatch.setattr(fa_mod._FlashLse, "apply", spy)
    mha = tnn.MultiHeadAttention(16, 2, causal=True, block_size=64,
                                 attention_impl="flash")
    o = mha.attend(q, k, v)
    assert tiles == [64]
    np.testing.assert_allclose(
        o.numpy(), dot_product_attention(q, k, v, causal=True).numpy(),
        rtol=1e-5, atol=1e-6)


def test_block_size_survives_the_spec_rebuild():
    m = tnn.MultiHeadAttention(16, 2, causal=True, block_size=4)
    rebuilt = build_module(module_spec(m), device="cpu")
    assert rebuilt.block_size == 4
    # a spec from before the blockwise core rebuilds unpinned
    spec = module_spec(tnn.MultiHeadAttention(16, 2))
    del spec["state"]["block_size"]
    assert build_module(spec, device="cpu").block_size is None


# --------------------------------------------------------------------------- #
# the CLIs                                                                    #
# --------------------------------------------------------------------------- #

def _cli(module, *args, env=None):
    r = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                        *args], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]


def test_attention_bench_autotune_resumes_and_use_tuned(tmp_path):
    env = dict(os.environ,
               BIGDL_TPU_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"))
    mod = "bigdl_tpu_torch.models.utils.attention_bench"
    args = ["--autotune", "--sweep", "32", "--headDim", "8", "--dtype",
            "float32", "--heads", "2", "--iters", "1", "--json",
            str(tmp_path / "tune.json")]
    _cli(mod, *args, env=env)
    first = (tmp_path / "tune.json").read_bytes()
    second = _cli(mod, *args, env=env)
    tune = json.loads((tmp_path / "tune.json").read_bytes())
    assert tune["complete"] is True and tune["platform"] == "cpu"
    # the second run re-measured nothing and left the certified doc as
    # it was
    rows = [r for r in second if "kind" in r]
    assert len(rows) == 3
    assert all(r.get("reused_from_previous_run") for r in rows)
    assert (tmp_path / "tune.json").read_bytes() == first
    bench = str(tmp_path / "attn.json")
    rows = _cli(mod, "--sweep", "32", "--naive", "--useTuned", "--headDim",
                "8", "--dtype", "float32", "--heads", "2", "--iters", "1",
                "--json", bench, env=env)
    assert [r["impl"] for r in rows] == ["flash", "naive_xla"]
    doc = json.load(open(bench))
    assert doc["complete"] is True and doc["platform"] == "cpu"
    w = tune["winners"][autotune.attention_key(32, 8, "float32", True)]
    f = next(r for r in doc["rows"] if r["impl"] == "flash")
    assert (f["block_q"], f["block_k"]) == (w["block_q"], w["block_k"])
    s = next(s for s in doc["summary"] if s["seq_len"] == 32)
    assert (s["block_q"], s["block_k"]) == (w["block_q"], w["block_k"])


def test_lm_perf_prints_one_line_with_the_reference_keys(tmp_path):
    rows = _cli("bigdl_tpu_torch.models.utils.lm_perf", "-t", "16", "-b",
                "2", "--vocab", "40", "--hidden", "32", "--heads", "2",
                "--layers", "1", "-i", "1", "--flash")
    assert len(rows) == 1
    want = {"metric", "seq_len", "batch", "vocab", "hidden", "heads",
            "layers", "flash", "remat", "optim", "dtype", "iters", "step_s",
            "tokens_per_s"}
    assert want <= set(rows[0]) and rows[0]["platform"] == "cpu"
    assert rows[0]["metric"] == "transformer_lm_train_step"
    assert rows[0]["flash"] is True and rows[0]["step_s"] > 0
    assert not list(tmp_path.iterdir())


def test_models_utils_is_a_package_with_the_old_helpers():
    r = subprocess.run(
        [sys.executable, "-c",
         "import bigdl_tpu_torch.models.utils as u; "
         "print(all(callable(getattr(u, n)) for n in ('lm_dataset', "
         "'restore_optim_state', 'resolve_resume')), u.__path__ != [])"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["True", "True"]
