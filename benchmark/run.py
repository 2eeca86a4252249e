"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

From the root of a checkout.  With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics.  The last line
of standard output is one JSON object (correct, attempted, failed,
metrics, device, [breakdown], checks); the numbers compared for
`correct`, each beside its limit, are also the last lines of standard
error.  Exits 2 without a result when there is no CUDA device (or fewer
than the cell asks for), and 3 when a module of JAX or of the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
FORBIDDEN = ("jax", "jaxlib", "flax", "como_tpu")


def set_cache_dirs() -> None:
    for var, sub in CACHE_DIRS.items():
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (como_tpu_torch is not como_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    import torch

    torch.set_num_threads(1)        # one host thread of CPU kernels (PERF.md)
    pre = {"import_s": time.perf_counter() - T_PROCESS}

    from benchmark import harness, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    pre["cuda_s"] = time.perf_counter() - T_PROCESS
    result, checks_text = harness.execute(bench, cell, args.seed, args.seconds,
                                          bool(args.trace), device="cuda",
                                          t_process=T_PROCESS, pre_parts=pre)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(checks_text, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
