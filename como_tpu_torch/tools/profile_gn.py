"""Per-stage profile of the mapping GN iteration on the bench's default and
stress windows (port of scripts/profile_gn.py).

Times five cumulative stages of the GN step, each as its own call on the
same demo window: the scaffold (_scaffold), + the dense points
(_dense_points), + the photometric linearization (_photo), the whole linear
system without the solve (gn_system), and the whole step (scaffold ..
Cholesky .. retract, _gn_step_impl).  Each stage's time is the minimum of 3
readings of --iters calls, every reading ended by a synchronize; the
differences between stages localize the cost.  The text lines are the JAX
script's; a last line holds the same numbers as one JSON object.

    python -m como_tpu_torch.tools.profile_gn

Runs on the card unless --device cpu is given (full size takes seconds per
call on the CPU); without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json

from como_tpu_torch.bench import gn_window, time_fn
from como_tpu_torch.tools.common import card_line, tool_device

WINDOWS = (
    ("k9_o24_192x256", dict(num_kf=9, num_ow=24, fill_ow=8, img_size=(192, 256))),
    ("k18_o48_192x256", dict(num_kf=18, num_ow=48, fill_ow=16, img_size=(192, 256))),
    ("k9_o24_384x512", dict(num_kf=9, num_ow=24, fill_ow=8, img_size=(384, 512))),
)
STAGES = ("scaffold", "+dense", "+photo", "+assemble", "full(step+solve)")


def stage_fns(pairs, K, dims, sigmas, damping: float = 1e-6) -> dict:
    """{stage label: fn(state)}: the cumulative stages of one GN step."""
    from como_tpu_torch.odom.backend import gn_step as g

    def scaffold_only(st):
        return g._scaffold(st, K, dims, sigmas.far_depth_ratio)

    def dense_only(st):
        sc = scaffold_only(st)
        return g._dense_points(st.replace(P_lm=sc["P_lm_new"]), sc, K, dims)

    def photo_only(st):
        sc = scaffold_only(st)
        st = st.replace(P_lm=sc["P_lm_new"])
        dn = g._dense_points(st, sc, K, dims)
        return g._photo(st, sc, dn, *pairs, K, dims, sigmas.occlusion_thresh,
                        sigmas.estimate_affine)

    def assemble_only(st):
        return g.gn_system(st, *pairs, K, dims, sigmas)

    def full_step(st):
        return g._gn_step_impl(st, *pairs, K, dims, sigmas, damping)

    return dict(zip(STAGES, (scaffold_only, dense_only, photo_only, assemble_only, full_step)))


def profile_window(device, iters: int = 5, reps: int = 3, **window) -> dict:
    """ms per call of each stage on one demo window (gn_window keywords),
    with the window's D, pairs and ND."""
    from como_tpu_torch.odom.backend.gn_step import SigmaStatic

    state, pairs, K, dims = gn_window(device, **window)
    fns = stage_fns(pairs, K, dims, SigmaStatic())
    ms = {name: 1e3 * min(time_fn(fn, state, device=device, warmup=1 if r == 0 else 0,
                                  iters=iters) for r in range(reps))
          for name, fn in fns.items()}
    return dict(D=dims.D, pairs=int(pairs[0].shape[0]), ND=dims.ND, ms=ms)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = tool_device(args.device)
    out = {}
    for tag, w in WINDOWS:
        r = out[tag] = profile_window(dev, iters=args.iters, **w)
        print(f"\n== {tag}  (D={r['D']}, pairs={r['pairs']}, ND={r['ND']})")
        prev = 0.0
        for name, v in r["ms"].items():
            print(f"  {name:<18} {v:8.2f} ms   (+{v - prev:6.2f})")
            prev = v
    print(json.dumps(dict(windows=out, iters=args.iters, card=card_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
