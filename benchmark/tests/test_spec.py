"""A configuration, traffic mix, metric reader or roofline function is
found by its name: dropping a file into its folder is the whole change."""

import json
import shutil

from benchmark import spec


def _copy(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return base


def test_every_name_in_benchmark_json_has_its_file():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        assert spec.load_config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert spec.load_traffic(w["traffic"])["name"] == w["traffic"]
    for m in bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
    for name in spec.roofline_names():
        mod = spec.load_module("rooflines", name)
        assert callable(mod.install) and callable(mod.nbytes) and callable(mod.nops)


def test_new_config_and_traffic_files_are_found(tmp_path):
    base = _copy(tmp_path)
    cfg = spec.load_config("como-seq-unet", base)
    cfg["name"] = "como-seq-new"
    (base / "configs" / "como-seq-new.json").write_text(json.dumps(cfg))
    mix = spec.load_traffic("clutter-orbit", base)
    mix["name"], mix["step"] = "clutter-new", 0.018
    (base / "traffic" / "clutter-new.json").write_text(json.dumps(mix))
    assert spec.load_config("como-seq-new", base)["name"] == "como-seq-new"
    assert spec.load_traffic("clutter-new", base)["step"] == 0.018


def test_new_metric_and_roofline_files_are_found(tmp_path):
    base = _copy(tmp_path)
    (base / "metrics" / "runtime.frames.py").write_text(
        "def read(run):\n    return len(run.window['frames'])\n")
    (base / "rooflines" / "new_fn.py").write_text(
        "def install(patch):\n    pass\n\n\ndef nbytes(N):\n    return 4 * N\n\n\n"
        "def nops(N):\n    return N\n")
    reader = spec.load_module("metrics", "runtime.frames", base)

    class Run:
        window = {"frames": [1, 2, 3]}

    assert reader.read(Run()) == 3
    assert "new_fn" in spec.roofline_names(base)
    assert spec.load_module("rooflines", "new_fn", base).nbytes(10) == 40


def test_metrics_of_follows_workloads_keys():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x.y"]}]}
    assert [m["name"] for m in spec.metrics_of(bench, "x.y", "per_layer")] == ["a", "b"]
    assert [m["name"] for m in spec.metrics_of(bench, "x.z", "per_layer")] == ["a"]
