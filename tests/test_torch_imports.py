"""The port stands alone: importing every como_tpu_torch module pulls in
neither jax nor como_tpu.  A subprocess, because tests/conftest.py has
already imported jax into this one."""

import ast
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import como_tpu_torch
import torch_testing  # noqa: F401  (one PyTorch thread per test worker)

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(como_tpu_torch.__path__,
                                                         "como_tpu_torch."))


def test_no_jax_in_port():
    mods = _modules()
    assert len(mods) > 50
    for new in ("runtime.queues", "runtime.placement", "runtime.pipeline", "utils.demo",
                "odom.backend.extra_factors", "parallel.sharded", "viz.geometry",
                "viz.renderer", "viz.viewer", "viz.png", "train.loss", "train.data",
                "train.optim", "train.train_depthcov", "train.select_checkpoint",
                "tools.gn_step_time", "bench", "tools.common", "tools.eval_matrix",
                "tools.bench_runtimes", "tools.run_full", "tools.profile_e2e",
                "tools.profile_gn", "tools.probe_pair_throughput", "tools.convert_replica_gt",
                "tools.convert_scannet_gt", "tools.cross_cov_bwd_probe"):
        assert f"como_tpu_torch.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'como_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_rule():
    """The package imports torch, numpy, yaml, the standard library and
    itself; cv2 and pyrealsense2 only inside data/datasets.py (and cv2
    inside train/data.py), open3d only
    inside viz/viewer.py (the probes under tools/ also borrow the timing
    helpers of chip_smoke.py)."""
    allowed = {"torch", "numpy", "yaml", "como_tpu_torch"}
    only_in = {"data/datasets.py": {"cv2", "pyrealsense2"}, "train/data.py": {"cv2"},
               "viz/viewer.py": {"open3d"},
               "tools/cross_cov_probe.py": {"chip_smoke"},
               "tools/cross_cov_bwd_probe.py": {"chip_smoke"}}
    pkg = Path(como_tpu_torch.__file__).parent
    files = sorted(pkg.rglob("*.py"))
    assert len(files) > 50
    for f in files:
        roots = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        extra = roots - allowed - set(sys.stdlib_module_names)
        ok = only_in.get(f.relative_to(pkg).as_posix(), set())
        assert extra <= ok, f"{f.relative_to(pkg)} imports {sorted(extra - ok)}"


# Public names of como_tpu without a namesake in the port, each with its
# counterpart there (ROADMAP.md section 1 lists the same).
COUNTERPARTS = {
    "HIGH": "jnp.matmul's precision flag; the port's f32 products run in f32 "
            "(TF32 off in como_tpu_torch/__init__.py)",
    "cache_dir": "JAX's persistent compile cache; eager PyTorch compiles nothing",
    "cross_covariance_pallas": "gp/kernels_cuda.py::cross_covariance (the CUDA kernel)",
    "pallas_available": "the TPU's Pallas gate; the port launches its kernels at every "
                        "CUDA size",
    "gn_step": "jax.jit of _gn_step_impl; the port calls _gn_step_impl",
    "gn_step_donating": "jax.jit of _gn_step_impl with donated buffers; likewise",
    "init_unet": "net/unet.py::UNet, initialised from a seed",
    "track_frame_fused": "runtime/seq.py's fused frame program",
    "StageTimer": "utils/profiling.py::RECORDER, the spans and counters of the engine path",
}


def _public_names(pkg: Path) -> set:
    names = set()
    for f in pkg.rglob("*.py"):
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_como_tpu_has_a_port():
    """A module-level def, class or constant of como_tpu either has a
    namesake in the port or a counterpart listed in COUNTERPARTS; and the
    helpers ported last are importable where their JAX modules mirror."""
    missing = _public_names(ROOT / "como_tpu") - _public_names(ROOT / "como_tpu_torch")
    assert missing == set(COUNTERPARTS), sorted(missing ^ set(COUNTERPARTS))
    import importlib

    for mod, names in {"ops.linalg": "masked_mad_sigma solve_chol lstsq_chol det2x2 inv2x2",
                       "ops.coords": "swap_xy coord_img_rc",
                       "ops.interp": "img_interp batched_img_interp batched_bilinear_sample",
                       "odom.backend.robust": "squared tukey TUKEY_T",
                       "geometry.lie": "so3_exp invert_se3_jac",
                       "gp.kernels": "pack_cov unpack_cov", "gp.sampler": "pack_prefix",
                       "gp.predictor": "predictor_from_cov_img"}.items():
        m = importlib.import_module(f"como_tpu_torch.{mod}")
        assert all(hasattr(m, n) for n in names.split()), mod
    from como_tpu_torch.ops.coords import coord_img_rc

    assert inspect.signature(coord_img_rc).parameters["device"].default == "cuda"


def test_entry_points_default_to_cuda():
    from como_tpu_torch import cli
    from como_tpu_torch.data.datasets import get_dataset
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.net.depthcov import DepthCovPrior, load_params
    from como_tpu_torch.odom.mapping import Mapping
    from como_tpu_torch.odom.tracking import Tracking
    from como_tpu_torch.runtime.pipeline import ComoPipeline
    from como_tpu_torch.runtime.placement import resolve_device, resolve_stage_devices
    from como_tpu_torch.runtime.seq import ComoSeq
    from como_tpu_torch.utils.checkpoint import load_mapping_state
    from como_tpu_torch.utils.demo import anchor_grid, make_demo_state

    for fn in (ComoSeq.__init__, ComoPipeline.__init__, resolve_device, resolve_stage_devices,
               anchor_grid, make_demo_state, Mapping.__init__, SyntheticDataset.__init__,
               get_dataset, DepthCovPrior.__init__, load_params, load_mapping_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert Tracking.__dataclass_fields__["device"].default == "cuda"
    assert '"--device", type=str, default="cuda"' in inspect.getsource(cli.main)


def test_mapping_passes_its_device_to_the_prior():
    """A Mapping on the CPU builds its prior (and the UNet's parameters)
    on the CPU, not on the prior's default device."""
    import numpy as np

    from como_tpu_torch.config import ComoConfig
    from como_tpu_torch.odom.mapping import Mapping

    cfg = ComoConfig()
    cfg.img_size = [48, 64]
    cfg.mapping.prior = "unet"
    m = Mapping(cfg.mapping, np.eye(3, dtype=np.float32), (48, 64), device="cpu")
    m.setup()
    assert m.prior.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in m.prior.unet.parameters())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU,
    and when it sits in a directory without the repository."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
