"""The port's checkpoint interop tools against the JAX package's (CPU):
``panst3r_torch/port_checkpoint.py`` (RoPE layouts, renames, the command
line) against ``tools/port_torch_checkpoint.py``, the reverse export
``panst3r_torch/tools/export_checkpoint.py`` against
``tools/export_torch_checkpoint.py``, ``weights.dump_jax_params``
against ``load_jax_params``, ``panst3r_torch/tools/verify_port.py``
against the cases of tests/test_verify_port.py, and the JAX-free
synthesizer ``tests/torch_reference_sd.py`` against
``tests/test_torch_demo.py::reference_state_dict``.  Every state_dict is
made from a seed; the small widths are the JAX tests' (dim 32, depth 2)
where the default head counts do not matter, and heads of 8 lanes (dims
128 / 96 at the default 16 / 12 heads) where they do."""
import dataclasses
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from panst3r_torch import port_checkpoint as tport
from panst3r_torch.models import presets as tpresets
from panst3r_torch.models.blocks import SelfAttention
from panst3r_torch.models.panst3r import PanSt3R, build_model
from panst3r_torch.models.upscalers import LoftUpUpscalerConfig
from panst3r_torch.ops.rope import rope2d_tables
from panst3r_torch.tools import export_checkpoint as texport
from panst3r_torch.tools import verify_port as tverify
from panst3r_torch.weights import dump_jax_params, load_jax_params
from tests.test_port_full import TAttn, torch_rope_2d_interleaved
from tests.test_torch_demo import reference_shapes as demo_shapes
from tests.torch_reference_sd import reference_shapes, reference_state_dict
from tests.torch_release import release_memory  # noqa: F401
from tools import export_torch_checkpoint as jexport
from tools import port_torch_checkpoint as jport
from tools import verify_port as jverify

ROOT = pathlib.Path(__file__).resolve().parent.parent
REGISTERED = ("tiny", "tiny_v2", "v1", "v2")


def _registered(name):
    return {"tiny": tpresets.tiny_config, "tiny_v2": tpresets.tiny_v2_config,
            "v1": tpresets.panst3r_v1_config,
            "v2": tpresets.panst3r_v2_config}[name]()


def _small(v2: bool, wide: bool = False):
    """tiny (v1) or tiny_v2 with the reference LoftUp (20 frequencies, two
    blocks); ``wide``: encoder 128, decoder and mixer 96 (heads of 8 at
    the port tool's default 16 / 12 heads)."""
    rep = dataclasses.replace
    cfg = tpresets.tiny_v2_config() if v2 else tpresets.tiny_config()
    if v2:
        cfg = rep(cfg, panoptic=rep(cfg.panoptic, upscaler=LoftUpUpscalerConfig(
            dim=16, n_freqs=20, num_heads=2, num_layers=2)))
    if wide:
        cfg = rep(cfg, encoder=rep(cfg.encoder, embed_dim=128, num_heads=16),
                  decoder=rep(cfg.decoder, enc_dim=128, dim=96,
                              num_heads=12))
        if v2:
            cfg = rep(cfg, panoptic=rep(cfg.panoptic, input_mixer=rep(
                cfg.panoptic.input_mixer, hidden_dim=96, num_heads=12)))
    return cfg


def _numpy_sd(cfg, seed=0):
    return {k: v.numpy() for k, v in reference_state_dict(cfg, seed).items()}


def _flat(tree):
    return dict(tport.flatten(tree))


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.asarray(fa[k]).tobytes() == np.asarray(fb[k]).tobytes(), k


# ------------------------------------------------------------- RoPE --

def test_interleave_to_half_perm_matches_jax():
    for D in (4, 8, 16, 64, 96):
        np.testing.assert_array_equal(tport.interleave_to_half_perm(D),
                                      jport.interleave_to_half_perm(D))
    with pytest.raises(ValueError, match="multiple of 4"):
        tport.interleave_to_half_perm(6)


def test_interleaved_attention_matches_reference(rng):
    """tests/test_port_full.py:167 with the port's SelfAttention: an
    interleaved-RoPE attention ported with rope_layout="interleaved"."""
    dim, heads, N = 32, 2, 6
    attn = TAttn(dim, heads)
    x = rng.standard_normal((1, N, dim)).astype(np.float32)
    pos = rng.integers(0, 9, (1, N, 2)).astype(np.int64)
    with torch.no_grad():
        tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
        qkv = attn.qkv(tx).reshape(1, N, 3, heads, dim // heads)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        q = torch_rope_2d_interleaved(q, tp)
        k = torch_rope_2d_interleaved(k, tp)
        att = (q @ k.transpose(-1, -2)) * (dim // heads) ** -0.5
        ref = attn.proj((att.softmax(-1) @ v).transpose(1, 2)
                        .reshape(1, N, dim)).numpy()

    sd = {f"m.{k}": v.detach().numpy() for k, v in attn.state_dict().items()}
    ctx = tport.Port(sd, rope_layout="interleaved")
    tree = {}
    tport._packed_qkv(ctx, tree, ("qkv",), "m.qkv", heads, rope=True)
    tport._linear(ctx, tree, ("proj",), "m.proj")
    ours = load_jax_params(SelfAttention(dim, heads), tree)
    with torch.no_grad():
        got = ours(tx, rope2d_tables(tp, dim // heads)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------- the port's CLI --

def _drifted(sd):
    return {re.sub(r"^must3r_decoder\.dec_blocks\.",
                   "must3r_decoder.decoder.blocks.", k): v
            for k, v in sd.items()}


RENAME = {r"^must3r_decoder\.decoder\.blocks\.": "must3r_decoder.dec_blocks."}


@pytest.mark.parametrize("case", ["half", "interleaved", "rename"])
def test_port_cli_files_equal_jax_tool(tmp_path, case):
    """ported_params.npz and port_report.json of the port's command line
    equal the JAX tool's on the same .pth, key for key and bit for bit
    (v2-shaped, at heads of 8 lanes for the interleaved layout)."""
    sd = _numpy_sd(_small(v2=True, wide=case == "interleaved"))
    flags = []
    if case == "interleaved":
        flags = ["--rope-layout", "interleaved"]
    if case == "rename":
        sd = _drifted(sd)
        (tmp_path / "m.json").write_text(json.dumps(RENAME))
        flags = ["--rename-json", str(tmp_path / "m.json")]
    torch.save({"weights": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "ckpt.pth")
    for name, tool in (("port", tport), ("jax", jport)):
        argv = ["--torch", str(tmp_path / "ckpt.pth"),
                "--out", str(tmp_path / name)] + flags
        if tool is tport and case == "half":    # as a user runs it
            subprocess.run([sys.executable, "-m",
                            "panst3r_torch.port_checkpoint"] + argv,
                           check=True, cwd=ROOT, capture_output=True)
        else:
            tool.main(argv)
    a = np.load(tmp_path / "port" / "ported_params.npz")
    b = np.load(tmp_path / "jax" / "ported_params.npz")
    assert a.files == b.files and len(a.files) > 100
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    rep = (tmp_path / "port" / "port_report.json").read_text()
    assert rep == (tmp_path / "jax" / "port_report.json").read_text()
    assert json.loads(rep)["unmapped"] == []

    rename = RENAME if case == "rename" else None
    layout = "interleaved" if case == "interleaved" else "half"
    ours, _ = tport.port_checkpoint(sd, rename=rename, rope_layout=layout)
    theirs, _ = jport.port_checkpoint(sd, rename=rename, rope_layout=layout)
    _assert_trees_equal(ours, theirs)
    if case == "interleaved":       # the layout moved rows: not the half tree
        half, _ = tport.port_checkpoint(sd)
        assert not np.array_equal(
            half["must3r_encoder"]["blocks"]["block"]["attn"]["qkv"]["kernel"],
            ours["must3r_encoder"]["blocks"]["block"]["attn"]["qkv"]["kernel"])


def test_implicit_biases_check_frequencies():
    x = np.zeros((2, 5, 20), np.float32)
    assert tport._implicit_biases(x, 20).shape == (2, 5, 20)
    with pytest.raises(ValueError, match="20 frequencies"):
        tport._implicit_biases(np.zeros((2, 5, 4), np.float32), 20)


# ---------------------------------------------------------- the export --

@pytest.mark.parametrize("layout", ["half", "interleaved"])
def test_export_roundtrip_bit_exact(layout):
    """tests/test_port_full.py:711 and :747 in the port: state_dict → port
    → export reproduces every key bit for bit; the export equals the JAX
    exporter's."""
    sd = _numpy_sd(_small(v2=True, wide=layout == "interleaved"), seed=2)
    ported, report = tport.port_checkpoint(sd, rope_layout=layout)
    assert report["unmapped"] == []
    out, rep = texport.export_checkpoint(ported, sd, rope_layout=layout)
    assert rep["missing"] == []
    assert set(rep["passthrough"]) == set(report["ignored"])
    assert list(out) == list(sd)
    for k in sd:
        assert out[k].dtype == sd[k].dtype
        np.testing.assert_array_equal(out[k], sd[k], err_msg=k)
    jout, jrep = jexport.export_checkpoint(ported, sd, rope_layout=layout)
    assert rep == jrep
    for k in sd:
        assert out[k].tobytes() == np.asarray(jout[k]).tobytes(), k


def test_export_model_matches_jax_exporter():
    """export_model of a port model with weights of its own equals the JAX
    exporter on the same tree, and loads back into the same parameters."""
    cfg = _small(v2=True)
    template = _numpy_sd(cfg)
    model = build_model(cfg, device="cpu", seed=7)
    out, rep = texport.export_model(model, template)
    jout, jrep = jexport.export_checkpoint(dump_jax_params(model), template)
    assert rep == jrep and rep["missing"] == []
    for k in template:
        assert out[k].tobytes() == np.asarray(jout[k]).tobytes(), k
    back = build_model(cfg, device="cpu", seed=8)
    tport.load_reference_state_dict(back, out)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(p, q), name


def test_export_cli_from_checkpoint_dir(tmp_path):
    """The command line from a core/checkpoint.py directory (bf16 weights,
    as a train run saves them) against an f32 template."""
    from panst3r_torch.core.checkpoint import save_checkpoint

    cfg = _small(v2=False)
    template = _numpy_sd(cfg)
    torch.save({"weights": {k: torch.from_numpy(v)
                            for k, v in template.items()}},
               tmp_path / "ref.pth")
    model = build_model(cfg, device="cpu", seed=9).to(torch.bfloat16)
    save_checkpoint(tmp_path, "final", model, cfg)
    rep = texport.main(["--checkpoint", str(tmp_path / "final"),
                        "--template", str(tmp_path / "ref.pth"),
                        "--out", str(tmp_path / "out.pth")])
    assert rep["missing"] == [] and rep["exported_keys"] == len(template) - 1
    sd = torch.load(tmp_path / "out.pth", weights_only=True)["weights"]
    back = build_model(cfg, device="cpu", seed=1)
    tport.load_reference_state_dict(back, sd)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(p.float(), q), name


@pytest.mark.parametrize("preset", REGISTERED)
def test_dump_jax_params_inverts_load(preset):
    """load_jax_params(fresh, dump_jax_params(m)) gives m's parameters bit
    for bit (the tiny presets; the full ones on the meta device: every
    leaf maps back to its parameter at its shape); the dumped tree has the
    JAX port tool's leaves and shapes."""
    cfg = _registered(preset)
    if preset.startswith("tiny"):
        model = build_model(cfg, device="cpu", seed=3)
        fresh = load_jax_params(build_model(cfg, device="cpu", seed=4),
                                dump_jax_params(model))
        for (name, p), (_, q) in zip(model.named_parameters(),
                                     fresh.named_parameters()):
            assert torch.equal(p, q), name
    with torch.device("meta"):
        meta = PanSt3R(cfg)
    tree = dump_jax_params(meta)
    load_jax_params(meta, tree, copy=False)
    if preset == "tiny":          # the reference layout of these widths
        jtree, _ = jport.port_checkpoint(_numpy_sd(cfg))
        assert {k: np.shape(v) for k, v in _flat(tree).items()} == \
            {k: np.shape(v) for k, v in _flat(jtree).items()}


# ------------------------------------------------------------ verify --

@pytest.fixture(scope="module")
def full_sd():
    """A complete v1-shaped checkpoint at the JAX tests' widths (encoder
    32 x 2, decoder 24 x 2, DINO 32 x 2, mask transformer 32 x 2)."""
    rep = dataclasses.replace
    cfg = tpresets.tiny_config()
    cfg = rep(cfg, encoder=rep(cfg.encoder, embed_dim=32, num_heads=2),
              decoder=rep(cfg.decoder, enc_dim=32, dim=24, num_heads=2),
              dino=rep(cfg.dino, depth=2))
    return _numpy_sd(cfg, seed=5)


def test_verify_pipeline_ok_on_well_formed(full_sd, monkeypatch):
    p = tverify.stage_port(dict(full_sd))
    assert p["status"] == "ok", p
    jp = jverify.stage_port(dict(full_sd))
    ported = p.pop("_ported_tree")
    _assert_trees_equal(ported, jp.pop("_ported_tree"))
    assert p == jp
    rt = tverify.stage_roundtrip(dict(full_sd), ported)
    assert rt["status"] == "ok", rt
    card = tverify.stage_card_parity(dict(full_sd), ported, device="cpu")
    assert card["status"] == "skipped" and "card" in card["reason"]
    # the comparison itself, CPU against CPU at a small scene
    monkeypatch.setattr(tverify, "PARITY_HW", (32, 48))
    cmp = tverify.compare_devices(dict(full_sd), ported, "cpu")
    assert cmp["status"] == "ok", cmp
    assert set(cmp["modules"]) == {"must3r_encoder", "dino_encoder",
                                   "must3r_decoder", "pointmaps_raw",
                                   "pred_logits", "pred_masks"}
    assert all(m.get("max_rel_err", m.get("max_abs_err")) == 0.0
               for m in cmp["modules"].values())
    assert cmp["dims"]["encoder"] == [32, 2, 1]


def test_verify_drifted_decoder_names_fail_loudly(full_sd):
    """``must3r_decoder.decoder.blocks.*``: the port stage fails with the
    pattern it tried and the closest keys, as the JAX stage does."""
    sd = _drifted(full_sd)
    p = tverify.stage_port(sd)
    assert p == jverify.stage_port(sd)
    assert p["status"] == "error"
    err = p["error"]
    assert err["missing_key_candidates_tried"]
    assert any(err["closest_in_checkpoint"].values())


def test_verify_missing_module_reported(full_sd):
    sd = {k: v for k, v in full_sd.items()
          if not k.startswith("dino_encoder.")}
    p = tverify.stage_port(sd)
    assert p["missing_modules"], "dropped module not reported"
    assert p["missing_modules"][0]["expected_prefix"] == "dino_encoder."
    assert p["status"] == "fail" and "missing modules" in p["reason"]


def test_verify_rename_json_bridges_drift(full_sd):
    p = tverify.stage_port(_drifted(full_sd), rename=RENAME)
    assert p["status"] == "ok", p


def test_verify_cli_end_to_end(tmp_path, full_sd):
    """main() on a .pth (weights_only) with --device cpu writes
    verify_report.json: ok, card_parity skipped with its reason, forward
    skipped (dims of no preset)."""
    torch.save({"weights": {k: torch.from_numpy(v)
                            for k, v in full_sd.items()}},
               tmp_path / "ckpt.pth")
    rep = tverify.main(["--torch", str(tmp_path / "ckpt.pth"),
                        "--out", str(tmp_path / "rep"), "--device", "cpu"])
    assert rep["verdict"] == "ok"
    on_disk = json.loads((tmp_path / "rep" / "verify_report.json")
                         .read_text())
    assert on_disk["verdict"] == "ok"
    stages = {s["stage"]: s for s in on_disk["stages"]}
    assert [s["stage"] for s in on_disk["stages"]] == \
        ["port", "roundtrip", "card_parity", "forward"]
    assert stages["card_parity"]["status"] == "skipped"
    assert "cpu" in stages["card_parity"]["reason"]
    assert stages["forward"]["status"] == "skipped"
    assert (tmp_path / "rep" / "ported_params.npz").exists()


def test_verify_forward_runs_a_preset_on_cpu(monkeypatch):
    """The forward stage matches a checkpoint to the preset of its dims
    (here the registered presets pointed at tiny / tiny_v2 + reference
    LoftUp) and runs its scene; the launches read 0 on the CPU."""
    monkeypatch.setattr(tverify, "PARITY_HW", (32, 48))
    for v2 in (False, True):
        cfg = _small(v2=v2)
        monkeypatch.setattr(tpresets, f"panst3r_{'v2' if v2 else 'v1'}"
                            "_config", lambda cfg=cfg: cfg)
        sd = _numpy_sd(cfg, seed=6)
        ported, _ = tport.port_checkpoint(sd)
        out = tverify.stage_forward(sd, ported, device="cpu")
        assert out["status"] == "ok", out
        assert out["preset"] == ("v2" if v2 else "v1") and out["finite"]
        assert set(out["launches"].values()) == {0}


def test_config_from_state_dict_at_the_presets():
    """The dims read back from a reference state_dict (shapes only) are the
    registered presets' own."""
    for name in ("v1", "v2", "tiny"):
        cfg = _registered(name)
        sd = {k: np.broadcast_to(np.float32(0), s)
              for k, s in reference_shapes(cfg).items()}
        got = tverify.config_from_state_dict(
            sd, enc_heads=cfg.encoder.num_heads,
            dec_heads=cfg.decoder.num_heads)
        if name != "tiny":            # the published heads: head dim 64/96
            assert got == cfg, name
        else:
            with torch.device("meta"):
                a, b = PanSt3R(got), PanSt3R(cfg)
            assert [(k, v.shape) for k, v in a.named_parameters()] == \
                [(k, v.shape) for k, v in b.named_parameters()]


def test_parity_limits_are_chip_smokes():
    assert tverify.PARITY_LIMITS["rel"] == chip_smoke.DINO_RTOL
    for key, atol, rtol in chip_smoke.SMALL_LIMITS:
        assert tverify.PARITY_LIMITS[key] == (atol, rtol)


# -------------------------------------------------------- synthesizer --

@pytest.mark.parametrize("preset", REGISTERED)
def test_synthesizer_matches_reference_state_dict(preset):
    """tests/torch_reference_sd.py (no JAX) has the keys and shapes of
    tests/test_torch_demo.py::reference_state_dict (the transcriptions of
    tests/test_port_full.py) at every registered preset."""
    cfg = _registered(preset)
    assert reference_shapes(cfg) == demo_shapes(cfg)
    if preset.startswith("tiny"):
        sd = reference_state_dict(cfg, seed=1)
        assert {k: tuple(v.shape) for k, v in sd.items()} == demo_shapes(cfg)
        assert all(v.dtype == torch.float32 for v in sd.values())
