"""The port stands alone: panst3r_torch and chip_smoke.py import neither JAX,
flax, panst3r_tpu nor tools — the machine with the card has none of them."""
import pathlib
import re
import subprocess
import sys

from tests.torch_release import release_memory  # noqa: F401

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
# so are the viewer, the gradio app, progress routing, the host
# rasterizer's package and the preprocessing tool
assert {"panst3r_torch.apps.viewer", "panst3r_torch.apps.gradio_app",
        "panst3r_torch.core.progress", "panst3r_torch.native",
        "panst3r_torch.tools.preprocess_scannetpp"} <= set(names)
# and the checkpoint interop tools
assert {"panst3r_torch.port_checkpoint",
        "panst3r_torch.tools.export_checkpoint",
        "panst3r_torch.tools.verify_port"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke  # import only: main() is not run
from tests.torch_reference_sd import reference_state_dict

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
from panst3r_torch.native import rasterize_mesh
depth, label = rasterize_mesh(
    np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32),
    np.array([[0, 1, 2]], np.int32), np.array([5], np.int32),
    np.array([[8, 0, 8], [0, 8, 8], [0, 0, 1]], np.float32), 16, 16)
assert label[8, 8] == 5 and abs(depth[8, 8] - 2) < 1e-5
from panst3r_torch.ops.attention import flash_attention_split_cls
x = torch.randn(1, 2, 5, 16)
c = torch.randn(1, 2, 1, 16)
op, oc = flash_attention_split_cls(x, x, x, c, c, c)
assert op.shape == x.shape and oc.shape == c.shape
# the wide-head engine's wrappers (csrc/flash_wide_sm90.cu) and a D = 256
# K4 / K5 / K3 call through their plain route
from panst3r_torch.ops import flash_attention as fa, masked_attention as ma
from panst3r_torch.ops import cuda_build
assert "flash_wide_sm90" in cuda_build.KERNEL_SOURCES
assert callable(fa._flash_wide_fwd_launch) and callable(
    fa._flash_wide_bwd_launch) and callable(ma._masked_wide_launch)
assert fa.kernel_head_dim(200) == 256 and fa.is_wide(256)
q, k = torch.randn(1, 2, 70, 256), torch.randn(1, 2, 90, 256)
o, lse = fa.flash_mha(q, k, k, with_lse=True)
dq, dk, dv = fa.flash_mha_bwd(q, k, k, o, lse, torch.randn_like(o))
assert o.shape == dq.shape == q.shape and dk.shape == dv.shape == k.shape
blocked = torch.rand(1, 70, 90) > 0.5
assert ma.masked_mha(q, k, k, blocked).shape == q.shape
from panst3r_torch.port_checkpoint import port_checkpoint, state_dict_of
from panst3r_torch.tools.export_checkpoint import export_checkpoint
from panst3r_torch.tools.verify_port import stage_port
sd = state_dict_of(reference_state_dict(tiny_config()))
assert stage_port(sd)["status"] == "ok"
out, _ = export_checkpoint(port_checkpoint(sd)[0], sd)
assert all(np.array_equal(out[k], sd[k]) for k in sd)
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
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_reference_sd.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, offenders
