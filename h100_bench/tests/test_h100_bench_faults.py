"""Whole runs on the CPU at a tiny size, past the look for a card: the
check passes on the program as it is, and comes out false with the timed
path broken underneath (each fault a cell can have), and on the
control in the program's place."""
import pytest
import torch

from h100_bench import run as run_py
from h100_bench.bench import common
from h100_bench.runners import train as train_runner
from h100_bench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def measure(root, name, trace=False):
    cell = common.Cell(common.load_benchmark(root), name, root)
    return run_py.measure(cell, 2 ** 31 + 17, 2.0, trace, device="cpu",
                          kind="cpu")


@pytest.mark.parametrize("name", ["xl-chat-poisson", "xl-docqa-shared",
                                  "small-train-32k"])
def test_sound_run_is_correct(root, name):
    out = measure(root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    names = list(out["checks"])
    assert names and all("limit" in c for c in out["checks"].values())


def test_traced_run_reads_its_per_layer_metrics(root):
    out = measure(root, "xl-docqa-shared", trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert set(m) == {"gen_lag_p95_ms", "queue_wait_p95_ms",
                      "prefix_hit_share"}
    assert m["prefix_hit_share"]["value"] > 0
    # no device trace on the CPU: the device readers find nothing
    chat = measure(root, "xl-chat-poisson", trace=True)["metrics"]
    assert {"decode_mfu", "gen_lag_p95_ms", "ttft_p95_ms.chat"} <= set(chat)
    assert "paged_decode_roofline" not in chat and "prefill_mfu" not in chat


@pytest.mark.parametrize("name", ["xl-chat-poisson", "xl-docqa-shared"])
def test_a_token_altered_where_produced_fails(root, name, monkeypatch):
    from bigdl_tpu_torch.serving.lm_engine import LMStream
    emit = LMStream._emit

    def altered(self, token_1b):
        # the third token of every stream comes out one id off
        if len(self._tokens) == 2:
            token_1b = token_1b % 97 + 1
        emit(self, token_1b)

    monkeypatch.setattr(LMStream, "_emit", altered)
    out = measure(root, name)
    assert not out["correct"]
    assert out["checks"]["served_logit_gap"]["value"] > \
        out["checks"]["served_logit_gap"]["limit"]


def test_a_step_that_leaves_its_state_unchanged_fails(root, monkeypatch):
    from bigdl_tpu_torch.optim.optim_method import OptimMethod
    monkeypatch.setattr(OptimMethod, "commit",
                        lambda self, staged, state: None)
    out = measure(root, "small-train-32k")
    assert not out["correct"]
    assert out["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_a_step_that_leaves_half_its_batch_out_fails(root, monkeypatch):
    from bigdl_tpu_torch.optim import optimizer
    full = optimizer.accumulated_loss_and_grads

    def half(model, criterion, params, data, labels, accum, **kw):
        n = data.shape[0] // 2
        return full(model, criterion, params, data[:n], labels[:n], accum,
                    **kw)

    monkeypatch.setattr(optimizer, "accumulated_loss_and_grads", half)
    out = measure(root, "small-train-32k")
    assert not out["correct"]


def test_the_control_fails_the_training_check(root):
    cell = common.Cell(common.load_benchmark(root), "small-train-32k", root)
    run = train_runner.TrainRun(cell, 23, 0.5, False, device="cpu")
    run.setup()
    run.window_run()
    run.free()
    run.verify(control=True)
    assert run.correct
    limits = cell.settings["check"]
    ctl = run.control["tf32"]
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_the_serving_control_goes_through_the_same_check(root):
    """The control's tokens, the ones the TF32 reference puts first at
    the sample's served positions, are judged as the program's are."""
    cell = common.Cell(common.load_benchmark(root), "xl-chat-poisson", root)
    run = cell.runner_module().Run(cell, 29, 1.0, False, device="cpu")
    run.setup()
    run.window_run()
    run.free()
    run.verify(control=True)
    assert run.correct
    ctl = run.control
    assert ctl["positions"] == run.check["tokens_compared"]["value"] > 0
    assert ctl["correct"] == (ctl["served_logit_gap"]
                              <= cell.settings["check"]["max_gap"])


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size():
    """The control at each cell's own size and load, three seeds: the
    reference in TF32 in the program's place comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from h100_bench import control
    bench = common.load_benchmark()
    for w in bench["workloads"]:
        cell = common.Cell(bench, w["name"])
        limits = cell.settings["check"]
        # a serving window long enough to finish a full sample
        seconds = 40.0 if cell.runner == "serve" else 10.0
        for seed in (101, 202, 303):
            r = control.readings(cell, seed, seconds)
            assert r["correct"], r
            ctl = r["control"]
            if cell.runner == "serve":
                assert not ctl["correct"], r
                assert ctl["served_logit_gap"] > limits["max_gap"], r
            else:
                assert any(ctl["tf32"][k] > limits[k] for k in limits), r
