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
# the multi-device layer is among them
assert {"panst3r_torch.core." + m for m in ("distributed", "mesh", "tp",
                                            "dryrun")} \
    | {"panst3r_torch.ops.sharded_attention"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke  # import only: main() is not run

import numpy as np
import torch
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
wires = eng.serve_many_device(np.stack([images, images[::-1].copy()]),
                              np.zeros((2, 3), bool),
                              rng.standard_normal((4, 24)).astype(np.float32))
assert wires.shape[0] == 2
from panst3r_torch.engine.retrieval import RetrievalHead
head = RetrievalHead(codebook=rng.standard_normal((8, 64)).astype(np.float32))
eng.retrieval_head = head
out = eng.run_device(images, np.zeros(3, bool),
                     rng.standard_normal((4, 24)).astype(np.float32),
                     use_retrieval=True)
assert len(set(out["keyframes"])) == 2
mem = eng.build_memory(*eng.encode_batch(torch.as_tensor(images[:2])),
                       refine_iterations=1)
assert mem.count == 2 * eng.n_tokens
from panst3r_torch.apps.slam import run_slam
frames = rng.integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
slam = run_slam(eng, frames, sim_threshold=1.1, max_interval=2, ba=True,
                ba_stride=2)
assert slam["poses"].shape == (4, 4, 4) and len(slam["ba_costs"]) == 8
from panst3r_torch.apps.eval import evaluate_scene
inst = np.zeros((32, 48), np.int64)
inst[4:20, 8:30] = 1
views = [{"img": rng.random((32, 48, 3)).astype(np.float32) * 2 - 1,
          "pan_inst_id": inst, "pan_cls_id": inst,
          "class_set": "wall;chair"} for _ in range(2)]
per_class = evaluate_scene(eng, views, ["chair", "wall"],
                           rng.standard_normal((2, 24)).astype(np.float32))
assert sum(s.tp + s.fn for s in per_class.values()) >= 1
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
