"""``BENCHMARK.json`` against the contract it is written to, and a cell,
mix and metric added as files alone."""
import json
import re

import pytest

from h100_bench.bench import common
from h100_bench.bench.common import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_names_units_and_entries():
    names = set()
    for key, allowed in (("configs", {"name", "source", "file", "reduced",
                                      "why"}),
                         ("workloads", {"name", "config", "traffic",
                                        "chips", "why"}),
                         ("end_to_end", {"name", "unit", "better", "bound",
                                         "source", "workloads"}),
                         ("per_layer", {"name", "unit", "better", "source",
                                        "layer", "moves", "workloads"})):
        for e in BENCH[key]:
            assert set(e) <= allowed, e
            assert NAME.match(e["name"]), e["name"]
            assert (key, e["name"]) not in names
            names.add((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_bounds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = common.Cell(BENCH, w["name"])
        e2e = [m["name"] for m in cell.metrics(trace=False)]
        layer = cell.metrics(trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert common.metric_reader(m["name"]).read is not None
        assert w["chips"] in (1, 4)


def test_configs_are_files_under_paths():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith("h100_bench/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))
            assert key not in ("n_embd", "n_head", "n_inner", "vocab_size")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_cell_added_as_files_is_found(tmp_path):
    from h100_bench.tests.tiny import tiny_root
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-chat-short", "config": "tiny",
                               "traffic": "chat-short", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "itl_p95_ms",
                               "workloads": ["tiny-chat-short"]})
    bench["end_to_end"][0]["workloads"].append("tiny-chat-short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    d = root / "h100_bench"
    (d / "cells/tiny-chat-short.json").write_text(
        (d / "cells/xl-chat-poisson.json").read_text())
    chat = json.loads((d / "traffic/chat-poisson.json").read_text())
    chat["rate_rps"] = 2.0
    # a new arrival process, found by the name the mix gives
    chat["arrivals"] = {"process": "evenly", "phase": 0.5}
    (d / "traffic/chat-short.json").write_text(json.dumps(chat))
    (d / "traffic/arrivals/evenly.py").write_text(
        "import numpy as np\n"
        "def starts(params, n, rate, seed):\n"
        "    return (np.arange(n) + params['phase']) / rate\n")
    (d / "metrics/requests_seen.py").write_text(
        "def read(ctx):\n    return len(ctx['records'])\n")
    cell = common.Cell(common.load_benchmark(root), "tiny-chat-short", root)
    assert cell.runner == "serve" and cell.traffic["rate_rps"] == 2.0
    assert [m["name"] for m in cell.metrics(trace=True)] == ["requests_seen"]
    reader = common.metric_reader("requests_seen", root)
    assert reader.read({"records": [1, 2, 3]}) == 3
    reqs = cell.traffic_kind().schedule(cell.traffic, 5, 10.0, 97,
                                        root=root)
    assert [r.due_s for r in reqs] == [0.25 + 0.5 * k for k in range(20)]
    assert cell.runner_module().run_cell is not None
    with pytest.raises(common.BenchError):
        common.plugin("runners", "no-such-runner", root)
    with pytest.raises(common.BenchError):
        common.Cell(common.load_benchmark(root), "no-such-cell", root)
