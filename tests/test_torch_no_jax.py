"""The port stands alone: panst3r_torch and chip_smoke.py import neither JAX,
flax, panst3r_tpu nor tools — the machine with the card has none of them."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "panst3r_tpu", "tools")

_SCRIPT = r"""
import importlib, pkgutil, sys
FORBIDDEN = %r

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import panst3r_torch
names = [m.name for m in pkgutil.walk_packages(panst3r_torch.__path__,
                                               "panst3r_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # import only: main() is not run

import numpy as np
from panst3r_torch.core.bucketing import Bucket
from panst3r_torch.engine.inference import InferenceEngine
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config

model = build_model(tiny_config(), device="cpu", seed=0)
eng = InferenceEngine(model, Bucket(32, 48), num_keyframes=2, chunk=2,
                      amp=False, device="cpu")
rng = np.random.default_rng(0)
out = eng.run_device(rng.integers(0, 256, (3, 32, 48, 3), dtype=np.uint8),
                     np.zeros(3, bool),
                     rng.standard_normal((4, 24)).astype(np.float32))
fused = eng.fuse(out, (32, 48))
assert fused[0]["pan"].shape == (3, 32, 48)
from panst3r_torch.ops.image import rgb_to_yuv420
images = rng.integers(0, 256, (3, 32, 48, 3), dtype=np.uint8)
wire = eng.serve_device(rgb_to_yuv420(images), np.zeros(3, bool),
                        rng.standard_normal((4, 24)).astype(np.float32),
                        fusion_res="hybrid", with_cameras=True,
                        keyframe_mode="retrieval")
dec = eng.unpack_wire(wire, 3, with_cameras=True, with_keyframes=2)
assert dec["pan"].shape == (3, 32, 48) and dec["focals"].shape == (3,)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT % (FORBIDDEN,)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 20


def test_no_forbidden_import_statements():
    pat = re.compile(r"^\s*(?:import|from)\s+(%s)\b" % "|".join(FORBIDDEN),
                     re.M)
    files = sorted((ROOT / "panst3r_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, offenders
