"""BENCHMARK.json keeps to its schema: keys, names, units, sizes and the time a full check takes."""

import json
import re

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time: (2 + 14 x 24) runs of
    # run_seconds + 60 s, 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_workloads():
    b = spec.load_benchmark()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)


def test_metrics():
    b = spec.load_benchmark()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for w in b["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(b, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        per_layer = spec.metrics_of(b, w["name"], "per_layer")
        assert per_layer and all(m["moves"] in reported for m in per_layer)
