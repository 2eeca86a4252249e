"""Finding a cell's pieces by name.

BENCHMARK.json (at the root of the checkout) lists the cells and metrics.
Everything that belongs to one configuration, traffic mix, per-layer
metric or roofline function is a file of its own under benchmark/, found
by its name:

    benchmark/configs/<config>.json      the configuration as it is run
    benchmark/traffic/<traffic>.json     the mix's parameters
    benchmark/metrics/<metric>.py        a reader: read(run) -> value or None
    benchmark/rooflines/<function>.py    install(wrap), bytes and operations

A cell is "<config>.<traffic>".  Adding one of these is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str, base: Path) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def load_traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def load_module(kind: str, name: str, base: Path = HERE):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_names(base: Path = HERE) -> list:
    return sorted(p.stem for p in (base / "rooflines").glob("*.py") if p.stem != "__init__")


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that the
    cell reports: those without a `workloads` key and those that list it."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]
