"""The port's text towers against the JAX package's and HF's (CPU, f32).

Tiny random HF modules (SigLIP, SigLIP2, CLIP) from the installed
transformers are ported by both packages' ``port_*_text``; the port's
towers run on those trees beside the flax towers and the HF modules, with
padding masks.  The CLIP byte-BPE is held against the JAX tokenizer and
HF's on vocab / merges files the test writes; the SigLIP tokenizers take an
injected ``encode`` object (no sentencepiece model is in the repository).
Tolerance: 2e-5 abs + 2e-4 rel against JAX and HF, as
tests/test_text_towers_native.py holds the flax towers to HF.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch import port_checkpoint as tport
from panst3r_torch.models import clip_text as tclip
from panst3r_torch.models import siglip_text as tsig
from panst3r_torch.models import text_encoder as tte
from panst3r_torch.models.siglip_text import tower_from_params
from panst3r_tpu.models import clip_text as jclip
from panst3r_tpu.models import siglip_text as jsig
from panst3r_tpu.models import text_encoder as jte
from tests.test_text_towers_native import _tiny_clip_files
from tools import port_torch_checkpoint as jport
from tests.torch_release import release_memory  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _trees(hf, which, layers):
    """(port tree, JAX tree) of one HF module, each by its own porter; the
    two must be equal and map every key."""
    out = []
    for mod in (tport, jport):
        ctx = mod.Port(_sd(hf))
        out.append(getattr(mod, f"port_{which}_text")(ctx, layers=layers))
        assert not ctx.unmapped(), ctx.unmapped()[:5]
    flat = [jax.tree_util.tree_leaves_with_path(t) for t in out]
    assert [p for p, _ in flat[0]] == [p for p, _ in flat[1]]
    for (_, a), (_, b) in zip(*flat):
        np.testing.assert_array_equal(a, b)
    return out


def _ids_mask(rng, B, N, vocab, lens, pad):
    ids = rng.integers(3, vocab - 3, (B, N)).astype(np.int64)
    mask = (np.arange(N)[None] < np.asarray(lens)[:, None]).astype(np.int64)
    ids = np.where(mask > 0, ids, pad)
    return ids, mask


@pytest.mark.parametrize("v2", [False, True])
def test_siglip_tower_matches_jax_and_hf(v2):
    """SigLIP (and SigLIP2, the same transformer): with the padding bias
    (K4's path on the card; its plain version here) against flax, and
    without a mask against HF, whose pooling and head the port shares."""
    import transformers

    name = "Siglip2Text" if v2 else "SiglipText"
    if not hasattr(transformers, f"{name}Model"):
        pytest.skip(f"transformers lacks {name}Model")
    torch.manual_seed(1 + v2)
    hf_cfg = getattr(transformers, f"{name}Config")(
        vocab_size=120, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16)
    hf = getattr(transformers, f"{name}Model")(hf_cfg).eval()
    ttree, jtree = _trees(hf, "siglip", 2)
    cfg = dict(vocab_size=120, width=32, layers=2, heads=4, mlp_dim=64,
               max_positions=16)
    tower = tower_from_params(tsig.SiglipTextTower,
                              tsig.SiglipTextConfig(**cfg), ttree, "cpu")
    jtower = jsig.SiglipTextTower(jsig.SiglipTextConfig(**cfg))
    ids, mask = _ids_mask(np.random.default_rng(2), 3, 16, 120, [5, 16, 1],
                          pad=1)
    with torch.no_grad():
        tp, th = tower(torch.from_numpy(ids), torch.from_numpy(mask))
        hp, hh = tower(torch.from_numpy(ids))
        ref = hf(input_ids=torch.from_numpy(ids))
    jp, jh = jtower.apply({"params": jtree}, jnp.asarray(ids, jnp.int32),
                          jnp.asarray(mask, jnp.int32))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(hh.numpy(), ref.last_hidden_state.numpy(),
                               **TOL)
    np.testing.assert_allclose(hp.numpy(), ref.pooler_output.numpy(), **TOL)
    assert tsig.SIGLIP2_CONFIG == tsig.SiglipTextConfig(vocab_size=256000)


def test_clip_tower_matches_jax_and_hf():
    """CLIP with the causal and pad biases (finfo.min twice: -inf) and the
    first-EOS pooling, against flax and HF."""
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(0)
    hf = CLIPTextModel(CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, eos_token_id=99,
        bos_token_id=98)).eval()
    ttree, jtree = _trees(hf, "clip", 2)
    cfg = dict(vocab_size=100, width=32, layers=2, heads=4, mlp_dim=64,
               max_positions=16, eos_id=99)
    tower = tower_from_params(tclip.ClipTextTower,
                              tclip.ClipTextConfig(**cfg), ttree, "cpu")
    jtower = jclip.ClipTextTower(jclip.ClipTextConfig(**cfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 90, (3, 10)).astype(np.int64)
    ids[0, 6:] = 99
    ids[1, 9] = 99
    ids[2, 2:] = 99
    mask = (np.cumsum(ids == 99, 1) <= 1).astype(np.int64)
    with torch.no_grad():
        tp, th = tower(torch.from_numpy(ids), torch.from_numpy(mask))
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask))
    jp, jh = jtower.apply({"params": jtree}, jnp.asarray(ids, jnp.int32),
                          jnp.asarray(mask, jnp.int32))
    for got, want in ((th, jh), (tp, jp),
                      (th, ref.last_hidden_state), (tp, ref.pooler_output)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_tokenizer_matches_jax_and_hf(tmp_path):
    from transformers import CLIPTokenizer

    vp, mp, _ = _tiny_clip_files(tmp_path)
    prompts = ["a photo of cat", "a photo of chair", "dog on wall!",
               "a photo of café", "über-dog, naïve cat", "  A   PHOTO of\tdog"]
    ours = tclip.ClipTokenizer(vp, mp)
    theirs = jclip.ClipTokenizer(vp, mp)
    for p in prompts:
        assert ours.encode(p) == theirs.encode(p)
    ids, mask = tclip.tokenize_clip(prompts, ours)
    jids, jmask = jclip.tokenize_clip(prompts, theirs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    enc = CLIPTokenizer(vocab_file=vp, merges_file=mp)(prompts, padding=True)
    np.testing.assert_array_equal(ids, np.asarray(enc["input_ids"]))
    np.testing.assert_array_equal(mask, np.asarray(enc["attention_mask"]))
    # truncation to max_len keeps BOS and EOS
    long_ids, _ = tclip.tokenize_clip(["cat " * 50], ours, max_len=8)
    np.testing.assert_array_equal(
        long_ids, jclip.tokenize_clip(["cat " * 50], theirs, max_len=8)[0])


class FakeSpm:
    """A stand-in sentencepiece: one id per word, from its letters."""

    def encode(self, text):
        return [3 + sum(map(ord, w)) % 90 for w in text.split()]


def test_siglip_tokenizers_match_jax():
    texts = ["This is a photo of wall.", "This is a photo of shower-curtain!",
             "  spaced\t out  ", "x", "w " * 80]
    for t in texts:
        assert tsig.canonicalize_text(t) == jsig.canonicalize_text(t)
    for fn in ("tokenize_siglip", "tokenize_siglip2"):
        for kw in ({}, {"max_len": 8}):
            got = getattr(tsig, fn)(texts, FakeSpm(), **kw)
            want = getattr(jsig, fn)(texts, FakeSpm(), **kw)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    got = tsig.tokenize_siglip2(texts, FakeSpm(), add_eos=True)
    want = jsig.tokenize_siglip2(texts, FakeSpm(), add_eos=True)
    np.testing.assert_array_equal(got[0], want[0])


def test_native_towers_match_jax(tmp_path):
    """Prompts → pooled embeddings end to end (tokenizer and tower): the
    port's NativeTextTower and NativeClipTower on the CPU against the
    JAX package's, from flax-initialized trees."""
    cfg = dict(vocab_size=100, width=16, layers=2, heads=2, mlp_dim=32,
               max_positions=64)
    jcfg = jsig.SiglipTextConfig(**cfg)
    params = jsig.SiglipTextTower(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    prompts = ["This is a photo of wall.", "This is a photo of chair.",
               "This is a photo of shower curtain."]
    got = tsig.NativeTextTower(params, FakeSpm(), tsig.SiglipTextConfig(
        **cfg), device="cpu")(prompts)
    want = jsig.NativeTextTower(params, FakeSpm(), jcfg)(prompts)
    assert got.dtype == np.float32 and got.shape == (3, 16)
    np.testing.assert_allclose(got, want, **TOL)

    vp, mp, _ = _tiny_clip_files(tmp_path)
    tok = jclip.ClipTokenizer(vp, mp)
    cfg = dict(vocab_size=len(tok.encoder), width=16, layers=1, heads=2,
               mlp_dim=32, max_positions=16, eos_id=tok.eos)
    jcfg = jclip.ClipTextConfig(**cfg)
    params = jclip.ClipTextTower(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    prompts = ["a photo of cat", "a photo of dog on the wall"]
    got = tclip.NativeClipTower(params, vp, mp, tclip.ClipTextConfig(**cfg),
                                device="cpu")(prompts)
    want = jclip.NativeClipTower(params, vp, mp, jcfg)(prompts)
    np.testing.assert_allclose(got, want, **TOL)


def test_text_encoder_semantics_match_jax():
    """set_vocab / load_table / __call__ / state and the fixed-vocab
    KeyError as the JAX package's, with the same tower_fn."""
    rng = np.random.default_rng(0)
    vecs = {}

    def tower(prompts):
        return np.stack([vecs.setdefault(p, rng.standard_normal(512) * 3)
                         for p in prompts])

    encs = [mod.TextEncoder(mod.TextEncoderConfig(model_name="clip"),
                            tower_fn=tower) for mod in (tte, jte)]
    assert tte.MODEL_CONFIGS == jte.MODEL_CONFIGS
    for e in encs:
        e.set_vocab(["cat", "dog"])
        e.load_table(["wall"], np.ones((1, 512)))
    t, j = encs
    np.testing.assert_array_equal(t(["dog", "wall", "cat"]),
                                  j(["dog", "wall", "cat"]))
    assert t.state()["classes"] == j.state()["classes"]
    np.testing.assert_array_equal(t.state()["embeddings"],
                                  j.state()["embeddings"])
    errs = []
    for e in encs:
        with pytest.raises(KeyError) as info:
            e(["cat", "table"])
        errs.append(str(info.value))
    assert errs[0] == errs[1]
    # an open vocabulary embeds what is missing
    opens = [mod.TextEncoder(mod.TextEncoderConfig("siglip", False),
                             tower_fn=lambda p: np.ones((len(p), 768)))
             for mod in (tte, jte)]
    np.testing.assert_array_equal(opens[0](["a", "b"]), opens[1](["a", "b"]))
    assert opens[0].state()["embeddings"].shape == (2, 768)
    empty = tte.TextEncoder().state()
    assert empty["embeddings"].shape == (0, 768)
