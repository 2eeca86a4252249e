"""Host and device time of one mapping GN step (gn_step._gn_step_impl) on
full-size demo windows (192x256, M = 64, utils/demo.make_demo_state):

  default  9 KF / 24 OW, 64 pairs (9 KF and 8 one-way frames filled)
  stress   18 KF / 48 OW, 130 pairs padded to 136 (chip_smoke's mesh window)
  radius   the default window with radius pairs: 288 pairs, the temporal
           ones valid and the rest padding

    python como_tpu_torch/tools/gn_step_time.py [--windows default stress radius] [--root DIR]

(by path, from the repository root, on a machine with an NVIDIA GPU).
--root DIR times DIR's como_tpu_torch (an earlier commit unpacked there),
so that two commits are compared in one call: parent, change, change,
parent.  Per window, one JSON line: host ms per step (median of 20, each
ended by a synchronize), and device ms and kernels per step with
chip_smoke.py's device_ms (5 steps), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WINDOWS = {"default": dict(num_kf=9, num_ow=24, fill_ow=8),
           "stress": dict(num_kf=18, num_ow=48, fill_ow=8, pad_to=8),
           "radius": dict(num_kf=9, num_ow=24, fill_ow=8, radius_pairs=True)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", nargs="+", default=list(WINDOWS), choices=list(WINDOWS))
    p.add_argument("--root", default=str(ROOT), help="import como_tpu_torch from this checkout")
    args = p.parse_args(argv)
    cs = _chip_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from como_tpu_torch.odom import window as win
    from como_tpu_torch.odom.backend import gn_step as gs
    from como_tpu_torch.utils.demo import make_demo_state

    dev, card = torch.device("cuda"), cs.card_line()
    for name in args.windows:
        w = WINDOWS[name]
        dims = win.make_dims(num_kf=w["num_kf"], num_ow=w["num_ow"],
                             radius_pairs=w.get("radius_pairs", False))
        if "pad_to" in w:
            dims = dims._replace(P=-(-dims.P // w["pad_to"]) * w["pad_to"])
        state, pairs, K = make_demo_state(dims, num_kf=w["num_kf"], num_ow=w["fill_ow"],
                                          device=dev)
        sig = gs.SigmaStatic()

        def step():
            gs._gn_step_impl(state, *pairs, K, dims, sig, 1e-6)

        host_ms = cs.time_ms(step, n=20)
        dev_ms, kernels, prof = cs.device_ms(step, n=5, label=name)
        package = str(Path(gs.__file__).parents[3])
        print(json.dumps(dict(window=name, pairs=dims.P, package=package,
                              host_ms_median=host_ms, device_ms=dev_ms, kernels_per_step=kernels,
                              device_profile=prof, card=card)), flush=True)
        del state
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
