"""DINO past K1's gate: the split-cls attention (``ops/attention.py``:
``flash_attention_split_cls``, K4 over the patches with its LSE and an
exact two-term merge of the cls column) and the concatenated path
(``DinoEncoderConfig.split_cls=False``), against the JAX package.

The port's merge arithmetic (``_split_cls_fixup``) runs here with K4's
launch replaced by its plain version with the LSE, and is held against
the JAX ``_split_cls_fixup`` (its Pallas ``_flash_fwd`` in interpret
mode) and ``_split_cls_ref`` at 2 x 4 x 130 x 64, f32, rtol 1e-5 / atol
2e-5; the gradients (the plain version's, recomputed, as JAX's
``custom_vjp``) against ``jax.vjp``.  Both DINO paths run on one loaded
parameter tree against JAX at JAX's own tolerance for the two paths
(tests/test_models.py: atol = rtol = 2e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.models.dino import DinoEncoder as TDino
from panst3r_torch.models.dino import DinoEncoderConfig as TDinoCfg
from panst3r_torch.ops import attention as t_attn
from panst3r_torch.ops import flash_attention as t_fa
from panst3r_torch.weights import load_jax_params
from panst3r_tpu.models.dino import DinoEncoder as JDino
from panst3r_tpu.models.dino import DinoEncoderConfig as JDinoCfg
from panst3r_tpu.ops import attention as j_attn
from tests.test_torch_models import random_params
from tests.torch_release import release_memory  # noqa: F401

TOL = dict(rtol=1e-5, atol=2e-5)
B, H, N, D = 2, 4, 130, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _streams(seed=0):
    """q, k, v (B, H, N, D) and qc, kc, vc (B, H, 1, D), jnp f32, logits
    at a std of about 2."""
    rng = np.random.default_rng(seed)
    out = []
    for n, s in ((N, 1.4), (N, 1.4), (N, 1.0), (1, 1.4), (1, 1.4),
                 (1, 1.0)):
        out.append(jnp.asarray(rng.standard_normal((B, H, n, D)) * s,
                               jnp.float32))
    return out


def test_split_cls_fixup_matches_jax(monkeypatch):
    """The port's K4 + merge (K4's plain version with its LSE) against the
    JAX fixup on its Pallas kernel in interpret mode and against the
    concatenated reference."""
    def plain_k4(q, k, v, bias, kv_valid, rope, scale, with_lse):
        return t_fa.flash_mha_ref(q, k, v, bias, kv_valid, rope, scale,
                                  with_lse=with_lse)

    monkeypatch.setattr(t_fa, "_flash_fwd_kernel", plain_k4)
    xs = _streams()
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = j_attn._split_cls_fixup(*xs, scale)
    ref = j_attn._split_cls_ref(*xs, scale)
    got = t_attn._split_cls_fixup(*map(_t, xs), scale)
    for g, w, r in zip(got, want, ref):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_split_cls_gradients_match_jax():
    """``flash_attention_split_cls`` on the CPU (the concatenated plain
    version, its gradient recomputed) against ``jax.vjp`` of the JAX
    function, whose ``custom_vjp`` differentiates the same reference."""
    xs = _streams(1)
    rng = np.random.default_rng(2)
    cots = [jnp.asarray(rng.standard_normal(s), jnp.float32)
            for s in ((B, H, N, D), (B, H, 1, D))]
    want_out, vjp = jax.vjp(j_attn.flash_attention_split_cls, *xs)
    want = vjp(tuple(cots))
    ts = [_t(x).requires_grad_() for x in xs]
    out = t_attn.flash_attention_split_cls(*ts)
    for o, w in zip(out, want_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), **TOL)
    got = torch.autograd.grad(out, ts, [_t(c) for c in cots])
    for name, g, w in zip(("q", "k", "v", "qc", "kc", "vc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("split_cls", [True, False])
@torch.no_grad()
def test_dino_paths_match_jax(split_cls):
    """``DinoEncoder`` with and without ``split_cls`` against the JAX
    encoder on one parameter tree (4 heads of 32: outside K1's gate, so
    the split-cls path goes through ``flash_attention_split_cls``)."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    kw = dict(embed_dim=128, depth=2, num_heads=4, pos_grid=5,
              layerscale_init=0.1)
    jm = JDino(JDinoCfg(**kw))
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(img))))
    jm = JDino(dataclasses.replace(JDinoCfg(**kw), split_cls=split_cls))
    want = jax.jit(jm.apply)(params, jnp.asarray(img))
    tm = load_jax_params(TDino(TDinoCfg(**kw, split_cls=split_cls)),
                         params).eval()
    got = tm(_t(img))
    assert got.shape == (2, 24, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
