"""The trained retrieval path of panst3r_torch against panst3r_tpu (CPU,
f32): ``RetrievalHead.project`` against the JAX head and against the torch
transcription of must3r's retrieval model in tests/test_retrieval_head.py,
the codebook words and residual bits, ``asmk_similarity`` and the
keyframes it selects, ``port_retrieval_checkpoint`` against the JAX
package's tool, and ``run_device(use_retrieval=True)`` through the
engine's ``retrieval_head``."""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panst3r_torch.core.bucketing import Bucket
from panst3r_torch.engine import retrieval as tret
from panst3r_torch.engine.inference import InferenceEngine
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.models.presets import tiny_config
from panst3r_torch.port_checkpoint import port_retrieval_checkpoint
from panst3r_tpu.engine import retrieval as jret
from tests.test_retrieval_head import _reference_forward, _torch_model
from tools.port_torch_checkpoint import \
    port_retrieval_checkpoint as tools_port_retrieval
from tests.torch_release import release_memory  # noqa: F401


def _checkpoint(m, codebook=None, residual=False, extra=None):
    """A retrieval checkpoint of the transcribed model ``m`` (backbone keys
    included, as the released files carry them)."""
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    sd["backbone.patch_embed.proj.weight"] = torch.zeros(4, 3, 2, 2)
    sd.update(extra or {})
    return {"model": sd, "args": argparse.Namespace(residual=residual),
            "asmk_codebook": None if codebook is None
            else {"centroids": torch.as_tensor(codebook)},
            "asmk_params": {"similarity": {"alpha": 3.0,
                                           "similarity_threshold": 0.0}}}


def _heads(ckpt):
    """The port's and the JAX package's heads from one checkpoint, each
    ported by its own package."""
    t = tret.RetrievalHead(**port_retrieval_checkpoint(ckpt))
    j = jret.RetrievalHead(**tools_port_retrieval(
        {k: ({n: v.numpy() for n, v in v.items()} if k == "model" else v)
         for k, v in ckpt.items()}))
    return t, j


def test_port_retrieval_checkpoint_matches_tools():
    """The same fields as the JAX package's tool, array for array; keys it
    cannot map raise."""
    rng = np.random.default_rng(0)
    ckpt = _checkpoint(_torch_model(), rng.standard_normal(
        (20, 16)).astype(np.float32), residual=True)
    ckpt["asmk_params"] = {"alpha": 2.5, "similarity_threshold": 0.1}
    got = port_retrieval_checkpoint(ckpt)
    want = tools_port_retrieval(
        dict(ckpt, model={k: v.numpy() for k, v in ckpt["model"].items()},
             asmk_codebook={"centroids": ckpt["asmk_codebook"]["centroids"]
                            .numpy()}))
    assert sorted(got) == sorted(want)
    assert got["residual"] is True and got["alpha"] == 2.5
    assert got["similarity_threshold"] == pytest.approx(0.1)
    for key in ("prewhiten", "postwhiten"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    assert len(got["projector"]) == len(want["projector"]) == 2
    for (wa, ba), (wb, bb) in zip(got["projector"], want["projector"]):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
    np.testing.assert_array_equal(got["codebook"], want["codebook"])
    with pytest.raises(ValueError, match="unmapped"):
        port_retrieval_checkpoint(_checkpoint(
            _torch_model(), extra={"mystery.weight": torch.zeros(3, 3)}))


def test_projection_matches_jax_and_torch():
    """Prewhiten, the GELU projector and postwhiten, then L2: within 2e-5 of
    the JAX head and of the transcribed torch model; the weights are the
    tokens' norms before projection.  The residual variant (a projector
    that keeps the width) against the JAX head."""
    rng = np.random.default_rng(1)
    m = _torch_model()
    th, jh = _heads(_checkpoint(m))
    x = rng.standard_normal((2, 50, 32)).astype(np.float32)
    got, w = th.project(torch.as_tensor(x))
    want, jw = jh.project(jnp.asarray(x))
    ref = _reference_forward(m, torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)

    m = _torch_model(hdims=(24, 32))
    th, jh = _heads(_checkpoint(m, residual=True))
    assert th.residual
    got, _ = th.project(torch.as_tensor(x))
    want, _ = jh.project(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_assign_and_binarize_matches_jax():
    """Top-1 codebook words and the ±1 residual bits equal JAX's."""
    rng = np.random.default_rng(2)
    codebook = rng.standard_normal((64, 16)).astype(np.float32)
    th, jh = _heads(_checkpoint(_torch_model(), codebook))
    x = rng.standard_normal((3, 40, 32)).astype(np.float32)
    words, bits, w = th.assign_and_binarize(torch.as_tensor(x))
    jwords, jbits, jw = jh.assign_and_binarize(jnp.asarray(x))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bits.dtype == torch.int8
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    with pytest.raises(ValueError, match="codebook"):
        tret.RetrievalHead().assign_and_binarize(torch.as_tensor(x))


def test_asmk_similarity_and_keyframes_match_jax(rng):
    """The clustered scene of tests/test_retrieval_head.py: the (V, V)
    ASMK* similarity within 1e-6 of JAX's, symmetric and separating the
    clusters, and the same keyframes; without a codebook both fall back to
    the pooled cosine."""
    D, K = 16, 64
    codebook = rng.standard_normal((K, D)).astype(np.float32)

    def views(word_ids, n_views=3, n_tok=40):
        return [codebook[rng.choice(word_ids, n_tok)]
                + rng.standard_normal((n_tok, D)) * 0.05
                for _ in range(n_views)]

    tokens = np.stack(views(np.arange(0, 8)) + views(np.arange(32, 40))
                      ).astype(np.float32)
    th = tret.RetrievalHead(codebook=codebook, alpha=3.0)
    jh = jret.RetrievalHead(codebook=codebook, alpha=3.0)
    sim = tret.asmk_similarity(th, torch.as_tensor(tokens))
    want = jret.asmk_similarity(jh, jnp.asarray(tokens))
    np.testing.assert_allclose(sim, want, atol=1e-6)
    np.testing.assert_allclose(sim, sim.T, atol=1e-6)
    across = sim[:3, 3:].mean()
    assert sim[:3, :3][np.triu_indices(3, 1)].mean() > across + 0.05
    for n in (2, 3, 5):
        got = tret.select_keyframes_retrieval(torch.as_tensor(tokens), n,
                                              head=th)
        assert got == jret.select_keyframes_retrieval(jnp.asarray(tokens),
                                                      n, head=jh)
    bare = tret.RetrievalHead()
    assert tret.select_keyframes_retrieval(torch.as_tensor(tokens), 3,
                                           head=bare) == \
        tret.select_keyframes_retrieval(torch.as_tensor(tokens), 3)


def test_run_device_uses_the_retrieval_head():
    """``run_device(use_retrieval=True)`` selects its keyframes with the
    engine's ``retrieval_head``: those of ``select_keyframes_retrieval``
    on the encoder's tokens with that head."""
    rng = np.random.default_rng(3)
    H, W, V, K = 32, 48, 6, 3
    cfg = tiny_config()
    C = cfg.encoder.embed_dim
    g = torch.Generator().manual_seed(0)
    ckpt = {"model": {"prewhiten.weight": torch.randn(C, C, generator=g)
                      / C ** 0.5,
                      "projector.0.weight": torch.randn(48, C, generator=g)
                      / C ** 0.5,
                      "projector.0.bias": torch.zeros(48),
                      "projector.2.weight": torch.randn(16, 48, generator=g)
                      / 48 ** 0.5,
                      "projector.2.bias": torch.zeros(16)},
            "asmk_codebook": torch.randn(32, 16, generator=g)}
    head = tret.RetrievalHead(**port_retrieval_checkpoint(ckpt))
    eng = InferenceEngine(build_model(cfg, device="cpu", seed=0),
                          Bucket(H, W), num_keyframes=K, chunk=2, amp=False,
                          device="cpu", retrieval_head=head)
    images = rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)
    out = eng.run_device(images, np.zeros(V, bool),
                         rng.standard_normal((4, 24)).astype(np.float32),
                         use_retrieval=True)
    with torch.inference_mode():
        x, _ = eng.encode_batch(torch.as_tensor(images))
    want = tret.select_keyframes_retrieval(x.float(), K, head=head)
    assert out["keyframes"] == want and len(set(want)) == K
