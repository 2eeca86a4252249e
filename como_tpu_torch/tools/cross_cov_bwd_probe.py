"""What limits the GP cross-covariance's backward kernel on the card:
variants timed side by side in one process, and operation counts from the
SASS.

    python -m como_tpu_torch.tools.cross_cov_bwd_probe [--baseline old_gp_kernels.cu]

(from the repository root, on a machine with an NVIDIA GPU and the CUDA
toolkit).  Builds, each with its own nvcc process, all started together:

  shipped   csrc/gp_kernels.cu as it is
  notail    every block returns before the sum over clusters (its anchor
            grads are not written where there is more than one cluster)
  ieee      the outputs with 4 a thread recomputed with the compiler's IEEE
            operations (IeeeOps): must equal the shipped kernel bit for bit
  ieeeonly  IeeeOps in place of FastOps, no recompute: the kernel as it
            would be written without the fast paths (what FastOps buys)
  empty     every block returns at once: the launch alone
  timeline  block 0's thread 0 reads clock64() between the kernel's phases
  fastmath  the same source built with --use_fast_math (approximate
            division, sqrtf and expf): what IEEE arithmetic costs
  site_thread         one thread per site (tools/cross_cov_bwd_site_thread.cuh,
                      appended to the shipped source): the layout first
                      planned, with the shipped arithmetic and sum over blocks
  site_thread_notail  the same, returning before the sum over clusters
  baseline  another source with the same C entry point (an earlier version
            of the kernel, called without the counter argument if it has no
            como_cross_covariance_bwd_plan), if --baseline names one

The variants are made from the shipped source by text substitution,
appending or flags at build time; they are not part of the kernel source.
The shipped, site_thread and baseline variants are held against autograd
of the plain version (max abs error over the four grads against the
largest |grad|); all are timed at 64 x 64, 1,024 x 64, 49,152 x 64,
3,000 x 96 and 777 x 131 with chip_smoke.py's device_ms (the kernels per
call beside each time), in the order a, b, ..., b, a so that drift shows;
shipped is compared bit for bit with ieee (a mismatch stops the probe) and
with ieeeonly at each shape; the launch plan and block 0's phases in SM
cycles (timeline) are reported per shape.  From `cuobjdump -sass`, per
kernel: operations, MUFU (special-function), branch and shuffle counts.
One JSON line per result; everything also lands in
chiprun_out/cross_cov_bwd_probe.json, the shipped library's disassembly in
chiprun_out/cross_cov_bwd_probe_sass.txt.
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
SITE_THREAD = PKG / "tools" / "cross_cov_bwd_site_thread.cuh"
OUT_DIR = PKG / "_build" / "bwd_probe"
SHAPES = ((64, 64), (1024, 64), (192 * 256, 64), (3000, 96), (777, 131))
TICKET = "  sum_over_clusters("
FAST4 = "        if (slow) {  // rare: the four again, with IEEE operations throughout\n"
START = "  cg::cluster_group cluster = cg::this_cluster();\n"
EDITS = {
    "notail": (TICKET, "  if (scale != -12345.0f) return;\n" + TICKET),
    "ieee4": (FAST4, FAST4.replace("(slow)", "(slow || scale != -12345.0f)")),
    "empty": (START, "  if (scale != -12345.0f) return;\n" + START),
    "ieee_ops": ("bwd_pair<FastOps>", "bwd_pair<IeeeOps>"),
    "no_recompute4": (FAST4, FAST4.replace("(slow)", "(false)")),
}


def _stamp(i):
    """Block 0's thread 0 writes clock64() into slot i of the counters
    buffer past its first 64 ints (the timeline variant)."""
    return ("  if (blockIdx.x == 0 && threadIdx.x == 0) "
            f"reinterpret_cast<long long*>(counter + 64)[{i}] = clock64();\n")


# (anchor, stamp after it?); the phases between stamps (the last panel's)
STAMPS = [("  if (tid == 0) s_last = 0;  // before the first cluster barrier\n", True),
          ("    __syncthreads();  // s_sd staged; s_ss and s_val free\n", True),
          ("#pragma unroll\n    for (int k = 0; k < BW_SUMS; ++k) s_val[w][k][lane] = acc[k];\n",
           False),
          ("    // the block's partial of each anchor of the panel", False),
          ("    cluster_arrive();\n    if (p0 + PW >= M) {", False),
          ("    cluster_wait();\n    // every block: the panel's anchors", False),
          ("    // every block: the panel's anchors a with a % CL == rank", False),
          ("    if (NC == 1) cluster_arrive_relaxed();  // this block no longer reads", False),
          ("    cluster_wait();  // every s_part read", False)]
PHASES = ["loads and staging", "outputs and site sums", "block barrier", "block partial",
          "site grads", "cluster barrier", "cluster sums (remote loads)", "anchor grads"]
for i, (anchor, after) in enumerate(STAMPS):
    EDITS[f"stamp{i}"] = (anchor, anchor + _stamp(i) if after else _stamp(i) + anchor)
# variant: the edits it makes, in order
VARIANTS = {"notail": ["notail"], "ieee": ["ieee4"],
            "ieeeonly": ["ieee_ops", "no_recompute4"], "empty": ["empty"],
            "timeline": [f"stamp{i}" for i in range(len(STAMPS))],
            "site_thread": [], "site_thread_notail": ["notail"]}
# variants with the one-site-a-thread kernel appended, called through its entry points
ENTRY = {"site_thread": "como_cross_covariance_bwd_site_thread",
         "site_thread_notail": "como_cross_covariance_bwd_site_thread"}
FLAGS = {"fastmath": ["--use_fast_math"]}


def _variants(baseline):
    text = SRC.read_text()
    out = {"shipped": (text, [])}
    for name, edits in VARIANTS.items():
        v = text + ("\n" + SITE_THREAD.read_text() if name in ENTRY else "")
        for e in edits:
            old, new = EDITS[e]
            if v.count(old) < 1:
                raise SystemExit(f"edit '{e}': its anchor text is not in gp_kernels.cu")
            v = v.replace(old, new)
        out[name] = (v, [])
    for name, flags in FLAGS.items():
        out[name] = (text, flags)
    if baseline:
        out["baseline"] = (Path(baseline).read_text(), [])
    return out


def _build(variants):
    from como_tpu_torch.cuda_lib import NVCC_FLAGS, _nvcc

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in variants.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        ptxas[name] = [ln for i, ln in enumerate(lines)
                       if "registers" in ln and any("bwd" in p for p in lines[max(0, i - 3):i])]
    return ptxas


_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(so: Path, keep: Path | None = None) -> dict:
    """Per backward kernel of a library: static SASS operation counts (the
    disassembly also written to `keep`, if given)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(so)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    if keep is not None:
        keep.write_text(text)
    kernels, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = kernels.setdefault(name, []) if "bwd" in name else None
        elif cur is not None:
            m = _INSTR.match(line)
            if m:
                cur.append(m.group(1))
    return {name: dict(sass_ops=sum(o != "NOP" for o in ops),
                       mufu=sum(o.startswith("MUFU") for o in ops),
                       branches=sum(o.startswith("BRA") for o in ops),
                       calls=sum(o.startswith("CALL") for o in ops),
                       shuffles=sum(o.startswith("SHFL") for o in ops))
            for name, ops in kernels.items()}


def _caller(so: Path, entry: str = "como_cross_covariance_bwd"):
    """(grad, x_n, e_n, x_m, e_m, scale) -> the four grads through `so`'s
    `<entry>_f32`, its scratch sized by `<entry>_scratch`."""
    import torch

    from como_tpu_torch import cuda_lib

    lib = ctypes.CDLL(str(so))
    scratch_floats = getattr(lib, f"{entry}_scratch")
    scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    scratch_floats.restype = ctypes.c_longlong
    new = hasattr(lib, "como_cross_covariance_bwd_plan")  # takes the counter argument
    fn = getattr(lib, f"{entry}_f32")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * (7 if new else 6)
    fn.restype = ctypes.c_int
    # the ticket counter (left zero by each launch), then the timeline's slots
    counters = torch.zeros(64 + 2 * len(STAMPS), dtype=torch.int32, device="cuda")

    def call(grad, x_n, e_n, x_m, e_m, scale):
        N, M = x_n.shape[0], x_m.shape[0]
        outs = [torch.empty(t.shape, dtype=torch.float32, device=x_n.device)
                for t in (x_n, e_n, x_m, e_m)]
        scratch = torch.empty(scratch_floats(N, M),
                              dtype=torch.float32, device=x_n.device)
        extra = [cuda_lib.ptr(counters)] if new else []
        cuda_lib.check(fn(*[cuda_lib.ptr(t) for t in (grad, x_n, e_n, x_m, e_m)],
                          ctypes.c_float(scale), N, M, *[cuda_lib.ptr(t) for t in outs],
                          cuda_lib.ptr(scratch), *extra, cuda_lib.stream_ptr(x_n.device)),
                       f"{entry}_f32")
        return outs

    call.counters = counters
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another .cu with the same C entry points")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cross_cov_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, device_ms

    from como_tpu_torch.gp import kernels_cuda

    results = []

    def emit(**kw):
        results.append(kw)
        print(json.dumps(kw), flush=True)

    card = card_line()
    emit(what="device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    variants = _variants(args.baseline)
    ptxas = _build(variants)
    for name in variants:
        keep = out / "cross_cov_bwd_probe_sass.txt" if name == "shipped" else None
        emit(what="sass", variant=name, ptxas=ptxas[name],
             kernels=sass_counts(OUT_DIR / f"lib{name}.so", keep))

    g = torch.Generator(device="cuda").manual_seed(0)

    def sites(n):
        x = torch.rand((n, 2), generator=g, device="cuda") * 2 - 1
        e = torch.rand((n, 3), generator=g, device="cuda") * 0.3 + 0.1
        e[:, 2] = (torch.rand(n, generator=g, device="cuda") - 0.5) * 0.1
        return x, e

    inputs = {}
    for N, M in SHAPES:
        inputs[(N, M)] = (torch.randn((N, M), generator=g, device="cuda"), *sites(N),
                          *sites(M), 1.3)
    calls = {name: _caller(OUT_DIR / f"lib{name}.so", ENTRY.get(name, "como_cross_covariance_bwd"))
             for name in variants}
    for name in ("shipped", "site_thread", "baseline"):
        if name not in calls:
            continue
        for shape, a in inputs.items():
            got = calls[name](*a)
            want = kernels_cuda.cross_covariance_vjp_plain(*a)
            err = max(float((x - y).abs().max()) for x, y in zip(got, want))
            gmax = max(float(y.abs().max()) for y in want)
            ok = all(float((x - y).abs().max()) <= 1e-5 + 1e-4 * float(y.abs().max())
                     for x, y in zip(got, want))
            emit(what="check", variant=name, shape=list(shape), max_abs_err=err,
                 max_abs_grad=gmax, ok=ok,
                 repeat_bitwise=all(torch.equal(x, y) for x, y in zip(got, calls[name](*a))))
            if not ok:
                raise SystemExit(f"variant {name} disagrees with autograd at {shape}")
    for shape, a in inputs.items():
        got = calls["shipped"](*a)
        same = all(torch.equal(x, y) for x, y in zip(got, calls["ieee"](*a)))
        emit(what="ieee_bitwise", shape=list(shape), shipped_equals_ieee=same,
             shipped_equals_ieeeonly=all(torch.equal(x, y)
                                         for x, y in zip(got, calls["ieeeonly"](*a))))
        if not same:
            raise SystemExit(f"the fast paths differ from the IEEE operations at {shape}")
    plan = ctypes.CDLL(str(OUT_DIR / "libshipped.so")).como_cross_covariance_bwd_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    tl = calls["timeline"]
    for shape, a in inputs.items():
        v = (ctypes.c_int * 4)()
        plan(shape[0], shape[1], v)
        emit(what="plan", shape=list(shape),
             **dict(zip(("sites_a_group", "sites_a_block", "blocks", "cluster"), list(v))))
        for _ in range(3):  # where block 0's time goes, in SM cycles
            tl(*a)
        torch.cuda.synchronize()
        ts = tl.counters[64:64 + 2 * len(STAMPS)].view(torch.int64).tolist()
        emit(what="timeline", shape=list(shape),
             cycles={p: ts[i + 1] - ts[i] for i, p in enumerate(PHASES)})
    order = list(calls)
    for shape, a in inputs.items():
        for name in order + order[::-1]:
            ms, kernels, _ = device_ms(lambda: calls[name](*a))
            emit(what="time", variant=name, shape=list(shape), device_us=ms * 1e3,
                 kernels_per_call=kernels, card=card)
    (out / "cross_cov_bwd_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
