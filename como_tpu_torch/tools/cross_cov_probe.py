"""What limits the GP cross-covariance kernel on the card: variants timed
side by side in one process, and operation counts from the SASS.

    python -m como_tpu_torch.tools.cross_cov_probe [--baseline old_gp_kernels.cu]

(from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit).  Builds, each with its own nvcc process, all started together:

  shipped   csrc/gp_kernels.cu as it is
  rowsR     the same with ROWS_PER_THREAD = R (1, 2, 8) for its fat tiles
  nostore   the store behind a condition that is never true at run time:
            what the arithmetic alone costs
  const     every output replaced by a staged value, all arithmetic gone:
            what the staging and the stores alone cost
  baseline  another source with the same C entry point (an earlier version
            of the kernel), if --baseline names one

The variants are made from the shipped source by text substitution at
build time; they are not part of the kernel source.  Each variant is held
against the plain PyTorch version (ablations excepted) and timed at
49,152 x 64, 64 x 64 and 1 x 64 with chip_smoke.py's device_ms, in the order
a, b, ..., b, a so that drift shows.  From `cuobjdump -sass`: operations
per kernel, after the barrier (the per-output part), per output (a thread
of the <VEC, R> kernel computes 4 R outputs), and the MUFU
(special-function) and STG (store) counts.  One JSON line per result;
everything also lands in chiprun_out/cross_cov_probe.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SRC = PKG / "csrc" / "gp_kernels.cu"
OUT_DIR = PKG / "_build" / "probe"
SHAPES = ((192 * 256, 64), (64, 64), (1, 64))
ROWS_LINE = "constexpr int ROWS_PER_THREAD = 4;"
ABLATIONS = {
    "nostore": ("    if (n < N) {\n      float* dst",
                "    if (n < N && scale == -12345.0f) {\n      float* dst"),
    "const": ("  return (w + w * t) * ex2_approx(t * -1.4426950408889634f);", "  return an;"),
}


def _variants(baseline):
    text = SRC.read_text()
    edits = {f"rows{r}": (ROWS_LINE, ROWS_LINE.replace("4", str(r))) for r in (1, 2, 8)}
    edits.update(ABLATIONS)
    out = {"shipped": text}
    for name, (old, new) in edits.items():
        if text.count(old) != 1:
            raise SystemExit(f"variant '{name}': its anchor text occurs {text.count(old)} times "
                             "in gp_kernels.cu, expected once")
        out[name] = text.replace(old, new)
    if baseline:
        out["baseline"] = Path(baseline).read_text()
    return out


def _build(variants):
    from como_tpu_torch.cuda_lib import NVCC_FLAGS, _nvcc

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        ptxas[name] = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return ptxas


_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(so: Path) -> dict:
    """Per kernel of a library: static SASS operation counts from cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(so)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    kernels, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = kernels.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSTR.match(line)
            if m:
                cur.append(m.group(1))
    out = {}
    for name, ops in kernels.items():
        bar = next((i for i, o in enumerate(ops) if o.startswith("BAR")), 0)
        body = [o for o in ops[bar:] if o != "NOP"]
        rows = re.search(r"cross_cov_kernelILb[01]ELi(\d+)E", name)
        per_thread = 4 * int(rows.group(1)) if rows else 1     # outputs of one thread
        out[name] = dict(sass_ops=len([o for o in ops if o != "NOP"]),
                         after_barrier=len(body), outputs_per_thread=per_thread,
                         after_barrier_per_output=len(body) / per_thread,
                         mufu=sum(o.startswith("MUFU") for o in body),
                         stg=sum(o.startswith("STG") for o in body),
                         branches=sum(o.startswith("BRA") for o in body))
    return out


def _caller(so: Path):
    import torch

    from como_tpu_torch import cuda_lib

    fn = ctypes.CDLL(str(so)).como_cross_covariance_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x_n, e_n, x_m, e_m, scale):
        out = torch.empty((x_n.shape[0], x_m.shape[0]), dtype=torch.float32, device=x_n.device)
        cuda_lib.check(fn(*[cuda_lib.ptr(t) for t in (x_n, e_n, x_m, e_m)],
                          ctypes.c_float(scale), cuda_lib.ptr(out), x_n.shape[0], x_m.shape[0],
                          cuda_lib.stream_ptr(x_n.device)), "como_cross_covariance_f32")
        return out

    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another .cu with the same C entry point")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cross_cov_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, device_ms, errors

    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.gp import kernels_cuda, sampler
    from como_tpu_torch.net.depthcov import DepthCovPrior

    results = []

    def emit(**kw):
        results.append(kw)
        print(json.dumps(kw), flush=True)

    card = card_line()
    emit(what="device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    variants = _variants(args.baseline)
    ptxas = _build(variants)
    for name in variants:
        emit(what="sass", variant=name, ptxas=ptxas[name],
             kernels=sass_counts(OUT_DIR / f"lib{name}.so"))

    # sites of a rendered 192x256 clutter frame; 64 anchors spread over them
    ds = SyntheticDataset(n_frames=1, img_size=(192, 256), seed=0, scene="clutter",
                          device="cuda")
    dom, e_dom, _, _ = sampler.full_image_domain(DepthCovPrior().cov_params(ds[0][1]), 0)
    dom, e_dom = dom.contiguous(), e_dom.contiguous()
    pick = torch.arange(64, device="cuda") * (dom.shape[0] // 64) + 391
    x_m, e_m = dom[pick].contiguous(), e_dom[pick].contiguous()
    inputs = {(192 * 256, 64): (dom, e_dom, x_m, e_m), (64, 64): (x_m, e_m, x_m, e_m),
              (1, 64): (dom[20000:20001], e_dom[20000:20001], x_m, e_m)}
    calls = {name: _caller(OUT_DIR / f"lib{name}.so") for name in variants}
    for name, call in calls.items():
        if name in ABLATIONS:
            continue
        for shape in SHAPES:
            a = inputs[shape]
            got, want = call(*a, 1.0), kernels_cuda.cross_covariance_plain(*a, 1.0)
            torch.cuda.synchronize()
            abs_err, rel_err, ok = errors(got, want)
            emit(what="check", variant=name, shape=list(shape), max_abs_err=abs_err,
                 max_rel_err=rel_err, ok=ok, repeat_bitwise=bool(torch.equal(got, call(*a, 1.0))))
            if not ok:
                raise SystemExit(f"variant {name} disagrees with the plain version at {shape}")
    order = list(calls)
    for shape in SHAPES:
        a = inputs[shape]
        for name in order + order[::-1]:
            ms, _, _ = device_ms(lambda: calls[name](*a, 1.0))
            emit(what="time", variant=name, shape=list(shape), device_ms=ms, card=card)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cross_cov_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
