"""BENCHMARK.json read by name: every cell's files exist, every metric has
its reader, and a run without a card prints no result."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in spec["end_to_end"] + spec["per_layer"])) \
        == len(spec["end_to_end"]) + len(spec["per_layer"])
    assert 1 <= spec["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_cell_reports(spec, kind):
    for w in spec["workloads"]:
        got = common.metric_names(spec, w["name"], kind)
        assert got, (w["name"], kind)
        if kind == "end_to_end":
            assert {m["name"] for m in got} > {"setup_s"}


def test_cells_found_by_name(spec):
    for w in spec["workloads"]:
        ctx = common.cell(w["name"])
        assert ctx["workload"] == w
        assert common.driver(ctx["traffic"]["kind"]).run
        assert set(ctx["config"]) >= {"source", "config", "init", "limits",
                                      "reduced", "assumed"}


def test_per_layer_moves_a_reported_metric(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_every_reader_loads_and_reads_nothing_from_nothing(spec):
    empty = {"trace": {"busy_s": 0.5, "window_s": 1.0, "device": []},
             "marks": {}, "flops": 1e12, "pooler_calls": [], "stages": {},
             "images": 1, "model": {"pooler_window": 32}}
    for m in spec["per_layer"]:
        value = common.reader(m["name"])(empty)
        if m["name"].endswith(("mfu", "idle_share")):
            assert value is not None and value > 0, m["name"]
        else:
            assert value is None, m["name"]


def test_no_card_no_result(tmp_path):
    """Without CUDA (this machine) a run exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(common.BENCH, "run.py"), "--workload",
         "r50-predict-resident-b8", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0
    assert out.stdout.strip() == ""

