"""The port stands alone: importing every como_tpu_torch module pulls in
neither jax nor como_tpu.  A subprocess, because tests/conftest.py has
already imported jax into this one."""

import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import como_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(como_tpu_torch.__path__,
                                                         "como_tpu_torch."))


def test_no_jax_in_port():
    mods = _modules()
    assert len(mods) > 25
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'como_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda():
    from como_tpu_torch.data.synthetic import SyntheticDataset
    from como_tpu_torch.odom.mapping import Mapping
    from como_tpu_torch.odom.tracking import Tracking
    from como_tpu_torch.runtime.seq import ComoSeq

    for fn in (ComoSeq.__init__, Mapping.__init__, SyntheticDataset.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert Tracking.__dataclass_fields__["device"].default == "cuda"


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
