"""Published peaks of the chips the benchmark runs on, by the name that
torch.cuda.get_device_name() gives (NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_of(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}: add the chip to benchmark/peaks.py")
    return PEAKS[kind]


def bound_s(nbytes: float, nops: float, kind: str) -> float:
    """The least time the work needs on the chip: bytes over the memory's
    bandwidth or f32 operations over the f32 peak, whichever is larger."""
    p = peaks_of(kind)
    return max(nbytes / p["hbm_bytes_per_s"], nops / p["f32_flops_per_s"])
