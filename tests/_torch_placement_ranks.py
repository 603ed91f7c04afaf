"""The ranks of ``tests/test_torch_port_placement.py``'s gloo worlds.

This module imports nothing of JAX: a spawned rank imports only it and
the port.  Each job function runs on every rank of one world and returns
plain Python and numpy values, which ``_rank_main`` pickles per rank
(``<job>.<rank>.pkl``) for the test module to hold against the JAX
package's placement.  The models are the reference test's, built from
the same seeds (``build(seed)`` is bitwise the reference's tree).
"""
import os
import pickle
import time
import traceback

import numpy as np
import torch

#: the reference test's MLP (Linear 16/64/64/10) and its batch
MLP_SEED = 7
LM = dict(vocab_size=64, hidden_size=32, n_head=4, n_layers=2, ffn_size=64,
          max_len=64, attention_impl="xla")
LM_SEED = 3
LM_PROMPTS = ([3, 5, 7, 9], [2, 4, 6, 8, 10, 12], [11, 13, 17])
LM_ENGINE = dict(slots=2, cache_len=32, max_new_tokens=8,
                 prefill_buckets=(8,), enable_prefix_cache=False)


def mlp(seed=MLP_SEED):
    from bigdl_tpu_torch import nn
    return nn.Sequential(nn.Linear(16, 64), nn.ReLU(),
                         nn.Linear(64, 64), nn.ReLU(),
                         nn.Linear(64, 10)).build(seed, device="cpu")


def batch():
    return np.random.RandomState(0).randn(8, 16).astype(np.float32)


def lm(**over):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(device="cpu", **{**LM, **over}).build(LM_SEED)


def leaf_paths(params, path=()):
    """``(path, leaf)`` in the reference's flatten order (dict keys
    sorted), a QTensor as its children ``q`` (path + (0,)) and ``scale``
    (path + (1,)), as the reference's pytree node flattens."""
    from bigdl_tpu_torch.quant.qtensor import is_qtensor
    if isinstance(params, dict):
        for k in sorted(params):
            yield from leaf_paths(params[k], path + (k,))
    elif is_qtensor(params):
        yield path + (0,), params.q
        yield path + (1,), params.scale
    elif params is not None:
        yield path, params


def spec_of(t):
    """A DTensor's placements on a 1-D ``model`` mesh as the reference's
    PartitionSpec tuple: "model" at the sharded dim, None elsewhere."""
    from torch.distributed.tensor import Shard
    spec = [None] * t.ndim
    for pl in t.placements:
        if isinstance(pl, Shard):
            spec[pl.dim] = "model"
    return tuple(spec)


def _policy(world, slots, tp, per_rank=False):
    from bigdl_tpu_torch.serving import DeviceTopology, PlacementPolicy
    return PlacementPolicy(DeviceTopology(["cpu"] * world, per_rank=per_rank),
                           slots=slots, tp=tp)


def _two_slots(world):
    """Two slots over the whole world: TP2 each in a world of 4, one
    rank each (per-rank ``tp == 1`` slots) in a world of 2."""
    return _policy(world, 2, world // 2, per_rank=world == 2)


def _inject(spec):
    """Arm (or, with None, disarm) the fault injector in this rank."""
    from bigdl_tpu_torch.resilience import faults
    if spec is None:
        os.environ.pop(faults.ENV_SPEC, None)
    else:
        os.environ[faults.ENV_SPEC] = spec
        os.environ[faults.ENV_SEED] = "0"
    faults.refresh_from_env()


# --------------------------------------------------------------------- #
# jobs                                                                  #
# --------------------------------------------------------------------- #
def topology(rank, world):
    from bigdl_tpu_torch.serving import DeviceTopology
    topo = DeviceTopology.detect()
    host = DeviceTopology.detect("cpu")
    return {"describe": topo.describe(), "per_rank": topo.per_rank,
            "cpu": host.n_devices, "cuda_degraded":
                DeviceTopology.detect("cuda").degraded}


def rules(rank, world):
    """serving_tp_rules' spec for every leaf path at TP ``world``, float
    and int8, and shard_params_chunked's shards of a multi-chunk leaf."""
    from bigdl_tpu_torch.parallel.tensor_parallel import keystr
    from bigdl_tpu_torch.serving import serving_tp_rules, shard_params_chunked
    from bigdl_tpu_torch.parallel.mesh import NamedSharding
    slot = _policy(world, 1, world).acquire()
    out = {}
    for label, m in (("float", mlp()), ("int8", mlp().quantize())):
        r = serving_tp_rules(m, slot.mesh)
        out[label] = {keystr(p): (s.spec if s is not None else None)
                      for p, s in ((p, r(p, leaf))
                                   for p, leaf in leaf_paths(m.params))}
    m = mlp()
    sharded = shard_params_chunked(m.params, serving_tp_rules(m, slot.mesh),
                                   slot)
    out["sharded"] = {
        keystr(p): (spec_of(t), t.to_local().shape[0],
                    bool(torch.equal(t.full_tensor(), w)))
        for (p, t), (_, w) in zip(leaf_paths(sharded),
                                  leaf_paths(m.params))}
    # a (64, 128) leaf in 4 KB chunks: several chunked copies a shard
    x = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    big = shard_params_chunked(
        {"w": torch.from_numpy(x)},
        lambda path, leaf: NamedSharding(slot.mesh, ("model", None)), slot,
        chunk_bytes=4096)["w"]
    out["multi_chunk"] = (spec_of(big), tuple(big.to_local().shape),
                          big.full_tensor().numpy())
    return out


def serve(rank, world):
    """ServingEngine on one slot of TP ``world``: the reference test's
    warmup and batch, then the same rows through the lockstep batcher."""
    from bigdl_tpu_torch.serving import ServingEngine
    slot = _policy(world, 1, world).acquire()
    x = batch()
    out = {}
    with ServingEngine(mlp(), input_shape=(16,), buckets=(8,),
                       name=f"tp{world}", placement=slot) as eng:
        out["made"] = eng.warmup()
        out["y"] = eng._run_batch(x)
        out["w0"] = spec_of(eng._params["0"]["weight"])
        out["stage_device"] = str(eng.stager.stage(x).device)
        out["slot_device"] = str(slot.device)
        futs = [eng.submit(x[i:i + 1]) for i in range(len(x))]
        out["submitted"] = np.concatenate([f.result(timeout=120)
                                           for f in futs])
        st = eng.stats()
        out["hit_rate"] = st["compile_cache"]["hit_rate"]
        out["placement"] = st["placement"]
        out["cuda_graphs"] = eng.cuda_graphs
    return out


def serve_int8(rank, world):
    from bigdl_tpu_torch.serving import ServingEngine
    slot = _policy(world, 1, world).acquire()
    with ServingEngine(mlp().quantize(), input_shape=(16,), buckets=(8,),
                       name="tpq", placement=slot) as qe:
        w = qe._params["0"]["weight"]
        return {"y": qe._run_batch(batch()), "quant_dtype": qe.quant_dtype,
                "staged": qe._quant_bytes_staged, "q": spec_of(w.q),
                "scale": spec_of(w.scale), "compute": w.compute,
                "row_scale": spec_of(qe._params["2"]["weight"].scale)}


def replicaset(rank, world):
    """A one-replica set on a TP ``world`` slot, through its own
    (lockstep) batcher."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    pol = _policy(world, 1, world)
    rs = ReplicaSet(mlp(), n_replicas=1, input_shape=(16,), buckets=(8,),
                    max_batch_size=8, max_wait_ms=1.0, placement=pol)
    try:
        rs.warmup()
        x = batch()
        y = rs.predict(x, timeout=120)
        futs = [rs.submit(x[i:i + 1]) for i in range(len(x))]
        rows = np.concatenate([f.result(timeout=120) for f in futs])
        st = rs.stats()
    finally:
        rs.close()
    return {"y": y, "rows": rows,
            "device_ids": st["replicas"]["r0"]["placement"]["device_ids"],
            "slots_used": st["placement"]["slots_used"],
            "headroom_after": pol.headroom()}


def lm_serve(rank, world):
    """LMServingEngine on one slot of TP ``world``: every prompt
    submitted at once, the greedy streams read on every rank; then the
    model's default attention, and the kernels' wrappers asked for by
    name (their plain versions on these CPU tensors)."""
    from bigdl_tpu_torch.serving import LMServingEngine
    slot = _policy(world, 1, world).acquire()
    out = {}
    for label, model, kw in (
            ("default", lm(attention_impl="auto"), {}),
            ("kernels", lm(attention_impl="flash"),
             dict(decode_attn="paged_kernel"))):
        with LMServingEngine(model, name=label, placement=slot,
                             **LM_ENGINE, **kw) as eng:
            streams = [eng.submit(np.asarray(p)) for p in LM_PROMPTS]
            out[label] = [list(s.tokens(timeout=120)) for s in streams]
            st = eng.stats()
            out[label + "_impl"] = (st["attention_impl"], st["decode_attn"],
                                    model._mha.attention_impl)
    eng = LMServingEngine(lm(), name="tp", placement=slot, **LM_ENGINE)
    try:
        eng.warmup()
        streams = [eng.submit(np.asarray(p)) for p in LM_PROMPTS]
        out["streams"] = [list(s.tokens(timeout=120)) for s in streams]
        st = eng.stats()
        out["placement"] = st["placement"]
        out["decode_attn"] = st["decode_attn"]
        out["attention_impl"] = st["attention_impl"]
        out["cuda_graphs"] = eng.cuda_graphs
        out["ledger_tag"] = st["prefill_cache"]["ledger_tag"]
        out["embed"] = str(type(eng._params["embed"]).__name__)
    finally:
        eng.close()
    from bigdl_tpu_torch.serving import SpecConfig
    for label, spec in (("spec", SpecConfig(k=2)),
                        ("spec_tree", SpecConfig(k=2, tree=True))):
        eng = LMServingEngine(lm(), name=label, placement=slot, spec=spec,
                              **LM_ENGINE)
        try:
            eng.warmup()
            streams = [eng.submit(np.asarray(p)) for p in LM_PROMPTS]
            out[label] = [list(s.tokens(timeout=120)) for s in streams]
            out[label + "_verify_compiles"] = eng._verify_compiles
        finally:
            eng.close()
    return out


def _outcome(stream, timeout=120):
    """A stream's end as every rank of a slot must see it alike: its
    tokens, and how it ended (None, a truncation reason, or the error's
    type)."""
    try:
        toks = list(stream.tokens(timeout=timeout))
    except Exception as e:  # noqa: BLE001 - the outcome is the record
        return list(stream.generated), type(e).__name__
    return toks, (stream.truncation.reason
                  if stream.truncation is not None else None)


def lm_lifecycle(rank, world):
    """A TP ``world`` LM slot whose ranks see different things: a cancel
    and a deadline on one rank only, a queue bound on one rank only,
    and a hibernation asked on one rank and resumed on the other.  Each
    rank reports the streams' outcomes; they must agree, and the
    untouched streams must be the unplaced engine's."""
    from bigdl_tpu_torch.serving import LMServingEngine
    from bigdl_tpu_torch.serving.kvtier import HostBlockStore
    slot = _policy(world, 1, world).acquire()
    out = {}
    with LMServingEngine(lm(), name="lc", placement=slot,
                         **LM_ENGINE) as eng:
        p = [np.asarray(x) for x in LM_PROMPTS]
        s0 = eng.submit(p[0])
        s1 = eng.submit(p[1], max_new_tokens=24)
        if rank == 0:
            s1.cancel()
        s2 = eng.submit(p[2], deadline_s=0.001 if rank == 1 else 60.0)
        s3 = eng.submit(p[0])
        out["streams"] = [_outcome(s) for s in (s0, s1, s2, s3)]
        if rank == world - 1:
            eng.set_max_queue(0)
        try:
            s4 = eng.submit(p[1])
        except Exception as e:  # noqa: BLE001 - this rank's refusal
            out["refused"] = ([], type(e).__name__)
        else:
            out["refused"] = _outcome(s4)
        eng.set_max_queue(64)
        out["after"] = _outcome(eng.submit(p[2]))
        out["lifecycle"] = dict(eng.lifecycle)
    long = dict(LM_ENGINE, cache_len=64)
    with LMServingEngine(lm(), name="unplaced", device="cpu",
                         **long) as ref:
        out["long_ref"] = list(ref.submit(p[0], max_new_tokens=56).tokens(
            timeout=120))
    tier = HostBlockStore(host_bytes=1 << 20, name=f"tp-lc{rank}")
    with LMServingEngine(lm(), name="hib", placement=slot, kvtier=tier,
                         **long) as eng:
        s = eng.submit(p[0], max_new_tokens=56)
        it = s.tokens(timeout=120)
        toks = [next(it)]
        if rank == 0:
            out["hibernated"] = eng.hibernate(s)
        else:
            t0 = time.monotonic()
            while s.request_id not in eng._hibernated:
                assert time.monotonic() - t0 < 60, "never hibernated"
                time.sleep(0.001)
            out["hibernated"] = True
        if rank == world - 1:
            out["resumed"] = eng.resume(s)
        toks += list(it)
        out["long"] = toks
        out["hib_counts"] = (eng.hibernations, eng.resumes)
    return out


def serve_lifecycle(rank, world):
    """The padded-batch engine on a TP ``world`` slot: a future cancelled
    on rank 0 only, a deadline blown on the last rank only, a request
    refused by one rank's queue bound; every rank ends each request
    alike, and the rest are the oracle's rows."""
    from bigdl_tpu_torch.serving import ServingEngine
    slot = _policy(world, 1, world).acquire()
    x = batch()
    out = {}
    with ServingEngine(mlp(), input_shape=(16,), buckets=(8,),
                       max_batch_size=8, max_wait_ms=200.0,
                       name="lc", placement=slot) as eng:
        futs = []
        for i in range(len(x)):
            late = i == 5 and rank == world - 1
            futs.append(eng.batcher.submit(
                x[i:i + 1], deadline_s=0.001 if late else None))
            if i == 2 and rank == 0:
                futs[-1].cancel()
        rows = []
        for f in futs:
            try:
                rows.append(("ok", f.result(timeout=120)))
            except Exception as e:  # noqa: BLE001 - the outcome
                rows.append((type(e).__name__, None))
        out["rows"] = rows
        if rank == 0:
            eng.batcher.set_max_queue(0)
        try:
            f = eng.submit(x[:1])
        except Exception as e:  # noqa: BLE001 - this rank's refusal
            out["refused"] = type(e).__name__
        else:
            try:
                f.result(timeout=120)
                out["refused"] = None
            except Exception as e:  # noqa: BLE001
                out["refused"] = type(e).__name__
        eng.batcher.set_max_queue(64)
        out["after"] = eng.submit(x[:1]).result(timeout=120)
    return out


def refusals(rank, world):
    """What a rank may not build: an engine on a slot other ranks hold.
    A replica set and a disaggregated pair across rank groups build on
    every rank and serve from the driver."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import (DisaggCoordinator, PlacementError,
                                         ServingEngine)
    out = {}
    pol = _policy(world, world // 2, 2)
    slots = [pol.acquire() for _ in range(pol.slots_total)]
    other = next(s for s in slots if not s.holds_this_rank())
    try:
        ServingEngine(mlp(), input_shape=(16,), buckets=(8,),
                      placement=other)
    except PlacementError as e:
        out["engine"] = str(e)
    for s in slots:
        pol.release(s)
    rs = ReplicaSet(mlp(), n_replicas=2, input_shape=(16,), buckets=(8,),
                    max_batch_size=8, max_wait_ms=1.0, placement=pol)
    try:
        if rank == 0:
            out["replicaset"] = rs.predict(batch(), timeout=120)
    finally:
        rs.close()
    out["headroom_after_set"] = pol.headroom()
    co = DisaggCoordinator(lm(), prefill_replicas=1, decode_replicas=1,
                           placement=pol, **LM_ENGINE)
    try:
        if rank == 0:
            out["disagg"] = list(co.submit(np.asarray(LM_PROMPTS[0]))
                                 .tokens(timeout=120))
    finally:
        co.close()
    out["headroom_after_disagg"] = pol.headroom()
    return out


# --------------------------------------------------------------------- #
# forwarded sets: every rank builds and closes, rank 0 (the driver)     #
# submits; the slots are other ranks' (serving.placement.forward)       #
# --------------------------------------------------------------------- #
def _replicaset_rows(rs, x, n):
    """``n`` predicts of ``x`` (one after another, so the least-loaded
    pick alternates the replicas), and the set's stats."""
    ys = [rs.predict(x, timeout=120) for _ in range(n)]
    return ys, rs.stats()


def fwd_replicaset(rank, world):
    """A forwarded ReplicaSet of 2 over the two slots, float32 and int8:
    rows, placement stats, the slots given back; on a rank other than
    the driver, submit's refusal."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import PlacementError
    out = {}
    for label, model in (("float", mlp()), ("int8", mlp().quantize())):
        pol = _two_slots(world)
        rs = ReplicaSet(model, n_replicas=2, input_shape=(16,),
                        buckets=(8,), max_batch_size=8, max_wait_ms=1.0,
                        placement=pol)
        try:
            if rank == 0:
                out[label + "_made"] = rs.warmup()
                ys, st = _replicaset_rows(rs, batch(), 3)
                out[label] = ys
                out[label + "_stats"] = {
                    "device_ids": [st["replicas"][r]["placement"]
                                   ["device_ids"] for r in ("r0", "r1")],
                    "dispatched": [st["replicas"][r]["dispatched"]
                                   for r in ("r0", "r1")],
                    "slots_used": st["placement"]["slots_used"]}
            else:
                try:
                    rs.submit(batch())
                except PlacementError as e:
                    out["refused"] = str(e)
        finally:
            rs.close()
        out[label + "_headroom"] = pol.headroom()
    if world > 2:
        # both replicas off the driver (slot 0 held first): r0 on rank 1
        # is the set's reference replica, reached over its channel
        pol, held = _held_slot0(world)
        rs = ReplicaSet(mlp(), n_replicas=2, input_shape=(16,),
                        buckets=(8,), max_batch_size=8, max_wait_ms=1.0,
                        placement=pol)
        try:
            if rank == 0:
                ys, st = _replicaset_rows(rs, batch(), 2)
                out["off_driver"] = ys
                out["off_driver_stats"] = {
                    r: (v["placement"]["device_ids"], v["dispatched"])
                    for r, v in st["replicas"].items()}
                out["off_driver_cache"] = st["metrics"]["compile_cache"]
        finally:
            rs.close()
        pol.release(held)
    return out


def fwd_failover(rank, world):
    """Placed failover across ranks: r1's ranks die from its 3rd
    dispatch on (``serving.dispatch:die:name=r1,after=3``), 12
    single-row requests, every row served; the single engine's rows
    for the same requests."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import ServingEngine
    xs = np.random.RandomState(3).randn(12, 16).astype(np.float32)
    out = {}
    if rank == 0:
        with ServingEngine(mlp(), input_shape=(16,), max_batch_size=4,
                           max_wait_ms=1.0, device="cpu") as single:
            out["expected"] = [single.predict(xs[i:i + 1], timeout=120)
                               for i in range(len(xs))]
    _inject("serving.dispatch:die:name=r1,after=3")
    try:
        pol = _two_slots(world)
        rs = ReplicaSet(mlp(), n_replicas=2, input_shape=(16,),
                        max_batch_size=4, max_wait_ms=1.0,
                        failure_threshold=2, cooldown_s=300.0,
                        placement=pol)
        try:
            if rank == 0:
                out["got"] = [rs.predict(xs[i:i + 1], timeout=120)
                              for i in range(len(xs))]
                st = rs.stats()
                out["replicas"] = {r: (v["state"], v["placement"]["slot_id"],
                                       v["failures"])
                                   for r, v in st["replicas"].items()}
        finally:
            rs.close()
    finally:
        _inject(None)
    return out


def fwd_scale(rank, world):
    """scale_to and try_scale_up reach the other slot's ranks: 1 replica,
    scale_to(5) builds the second on its slot (2), try_scale_up() is
    refused (packed), scale_to(1) drains it and gives the slot back."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    pol = _two_slots(world)
    rs = ReplicaSet(mlp(), n_replicas=1, input_shape=(16,), buckets=(8,),
                    max_batch_size=8, max_wait_ms=1.0, placement=pol)
    out = {}
    try:
        if rank == 0:
            out["grown"] = rs.scale_to(5)
            out["headroom_grown"] = pol.headroom()
            ys, st = _replicaset_rows(rs, batch(), 2)
            out["rows"] = ys
            out["dispatched"] = {r: v["dispatched"]
                                 for r, v in st["replicas"].items()}
            out["packed"] = rs.try_scale_up()
            out["shrunk"] = rs.scale_to(1)
            out["headroom_shrunk"] = pol.headroom()
            out["after"] = rs.predict(batch(), timeout=120)
    finally:
        rs.close()
    out["headroom_closed"] = pol.headroom()
    return out


def _pair_streams(co, prompts, **kw):
    streams = [co.submit(np.asarray(p), **kw) for p in prompts]
    return [list(s.tokens(timeout=120)) for s in streams]


def _pair_stats(st):
    return {k: st[k] for k in ("migrations", "migrated_blocks",
                               "migrated_bytes", "lost_payloads",
                               "re_prefills", "adopted", "phase_counts")}


def fwd_disagg(rank, world):
    """A forwarded DisaggCoordinator, 1 prefill + 1 decode over the two
    slots: greedy streams and the hop's accounting; then the same under
    ``serving.migrate:backend_lost`` (every payload lost: the decode
    slot re-prefills)."""
    from bigdl_tpu_torch.serving import DisaggCoordinator, PlacementError
    out = {}
    for label, fault in (("clean", None), ("lost", "serving.migrate:"
                                           "backend_lost")):
        pol = _two_slots(world)
        _inject(fault)
        try:
            co = DisaggCoordinator(lm(), prefill_replicas=1,
                                   decode_replicas=1, placement=pol,
                                   name=f"fwd-{label}", **LM_ENGINE)
            try:
                if rank == 0:
                    co.warmup()
                    out[label] = _pair_streams(co, LM_PROMPTS)
                    st = co.stats()
                    out[label + "_stats"] = _pair_stats(st)
                    out[label + "_placement"] = {
                        n: e["placement"] for n, e in st["engines"].items()}
                elif label == "clean":
                    try:
                        co.submit(np.asarray(LM_PROMPTS[0]))
                    except PlacementError as e:
                        out["refused"] = str(e)
            finally:
                co.close()
        finally:
            _inject(None)
        out[label + "_headroom"] = pol.headroom()
    return out


def _held_slot0(world):
    """Per-rank slots with slot 0 held beforehand on every rank: a pair
    built next takes decode on rank 1 and prefill on rank 2 (a world of
    4), or decode on the driver and prefill on rank 1 (a world of 2,
    slot 0 then given back first)."""
    pol = _policy(world, world, 1, per_rank=True)
    held = pol.acquire() if world > 2 else None
    return pol, held


def fwd_cancel(rank, world):
    """A cancel on the driver ends the stream on the decode rank (rank 1
    in a world of 4; the driver's own decode replica, fed by rank 1's
    prefill, in a world of 2): the decode replica's rounds are slowed
    (``serving.cancel:latency``, its engine only), the client cancels
    after two tokens, and the decode engine retires the stream as
    cancelled."""
    from bigdl_tpu_torch.serving import DisaggCoordinator
    pol, held = _held_slot0(world)
    out = {}
    _inject("serving.cancel:latency:ms=20,name=fwd-cancel-decode0")
    try:
        co = DisaggCoordinator(lm(), prefill_replicas=1, decode_replicas=1,
                               placement=pol, name="fwd-cancel",
                               **dict(LM_ENGINE, cache_len=64))
        try:
            if rank == 0:
                s = co.submit(np.asarray(LM_PROMPTS[0]), max_new_tokens=56)
                it = s.tokens(timeout=120)
                got = [next(it), next(it)]
                s.cancel()
                got += list(it)
                out["tokens"] = got
                out["truncation"] = (s.truncation.reason
                                     if s.truncation is not None else None)
                st = co.stats()
                out["lifecycle"] = {n: e["lifecycle"]
                                    for n, e in st["engines"].items()}
                out["placement"] = {n: e["placement"]
                                    for n, e in st["engines"].items()}
        finally:
            co.close()
    finally:
        _inject(None)
    if held is not None:
        pol.release(held)
    return out


def fwd_remote_pair(rank, world):
    """A forwarded pair whose two replicas both sit on ranks other than
    the driver (slot 0 held beforehand on every rank: decode on rank 1,
    prefill on rank 2), the prefix cache on: two prompts sharing a
    17-token head, one after the other, so the second hop skips the
    block the decode radix holds (its lead's peek) and the adoption
    matches it."""
    from bigdl_tpu_torch.serving import DisaggCoordinator
    pol, held = _held_slot0(world)
    head = list(range(2, 19))
    prompts = (head + [40, 41], head + [50], LM_PROMPTS[2])
    out = {}
    co = DisaggCoordinator(lm(), prefill_replicas=1, decode_replicas=1,
                           placement=pol, name="fwd-remote",
                           **dict(LM_ENGINE, enable_prefix_cache=True,
                                  prefill_buckets=(32,)))
    try:
        if rank == 0:
            co.warmup()
            out["streams"] = [list(co.submit(np.asarray(p)).tokens(
                timeout=120)) for p in prompts]
            st = co.stats()
            out["stats"] = _pair_stats(st)
            out["placement"] = {n: e["placement"]
                                for n, e in st["engines"].items()}
            out["prompts"] = prompts
    finally:
        co.close()
    if held is not None:
        pol.release(held)
    out["headroom"] = pol.headroom()
    return out


def fwd_build_fails(rank, world):
    """Forwarded sets whose build fails, each on a fresh policy of the
    two slots: a ReplicaSet of 3 (the policy runs out on every rank), a
    pair of 2 prefill + 1 decode (no free placement slot on every rank),
    and a ReplicaSet whose second module cannot be served (only slot 1's
    ranks fail).  Each rank's error and seconds, the headroom after; then
    a set built in the same world serves."""
    from bigdl_tpu_torch.resilience import ReplicaSet
    from bigdl_tpu_torch.serving import DisaggCoordinator
    rs_kw = dict(input_shape=(16,), buckets=(8,), max_batch_size=8,
                 max_wait_ms=1.0)
    cases = (
        ("replicaset", lambda pol: ReplicaSet(mlp(), n_replicas=3,
                                              placement=pol, **rs_kw)),
        ("pair", lambda pol: DisaggCoordinator(
            lm(), prefill_replicas=2, decode_replicas=1, placement=pol,
            name="fwd-fails", **LM_ENGINE)),
        ("bad_module", lambda pol: ReplicaSet([mlp(), object()],
                                              placement=pol, **rs_kw)))
    out = {}
    for label, make in cases:
        pol = _two_slots(world)
        t0 = time.monotonic()
        try:
            made = make(pol)
        except Exception as e:  # noqa: BLE001 - the refusal under test
            out[label] = (type(e).__name__, str(e))
        else:
            made.close()
            out[label] = None
        out[label + "_s"] = time.monotonic() - t0
        out[label + "_headroom"] = pol.headroom()
    pol = _two_slots(world)
    rs = ReplicaSet(mlp(), n_replicas=2, placement=pol, **rs_kw)
    try:
        if rank == 0:
            out["after"] = rs.predict(batch(), timeout=120)
    finally:
        rs.close()
    return out


# --------------------------------------------------------------------- #
# the world                                                             #
# --------------------------------------------------------------------- #
def rank_main(rank, world, store, out_dir, jobs):
    torch.set_num_threads(1)
    from bigdl_tpu_torch.parallel.mesh import init_world, shutdown_world
    init_world("cpu", init_method=store, rank=rank, world_size=world)
    try:
        for name in jobs:
            try:
                res = {"ok": globals()[name](rank, world)}
            except Exception:
                res = {"error": traceback.format_exc()}
            with open(os.path.join(out_dir, f"{name}.{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        shutdown_world()


def start(world, jobs, out_dir):
    import torch.multiprocessing as mp
    store = f"file://{os.path.join(str(out_dir), 'store')}"
    return mp.start_processes(rank_main, args=(world, store, str(out_dir),
                                               list(jobs)),
                              nprocs=world, join=False, start_method="spawn")
