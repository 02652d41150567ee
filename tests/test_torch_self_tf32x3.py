"""The arithmetic of the f32 K1 (tower self-attention) and the f32 K6
(head-packed flash) on the f32 K4's Hopper engine (csrc/flash_fwd_sm90.cu:
K/V hi/lo planes from a pre-pass, 3xTF32 products, per-step f32 adds),
checked without a card: the emulations ``tower_self_split_ref`` (strided
views of the fused qkv, the cls key/value one more unrotated key row) and
``packed_mha_split_ref`` (the heads of both head-pair layouts as strided
views) with their products put through ``ops/tf32x3.py::matmul_tf32x3``,
against the JAX package's Pallas ``_tower_fwd`` and the A/B tool's
``packed_mha`` in interpret mode, at chip_smoke.py's f32 limit, 1e-4
absolute; and the wrappers' stride helpers against ``split_heads``.  The
CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import packed_attention as pa
from panst3r_torch.ops import tower_attention as ta
from panst3r_torch.ops.tf32x3 import matmul_tf32x3
from panst3r_tpu.ops.pallas import tower_attention as j_ta
from panst3r_tpu.ops.rope import rope2d_tables
from tools import ab_attention_packed as j_ab
from tests.torch_release import release_memory  # noqa: F401

F32_TOL = 1e-4        # chip_smoke.py's limit for the f32 kernels
QK_STD = 1.4          # chip_smoke.py's: logits with a std of about 2
C, HEADS = 128, 2
# case: (B, N, rope, cls); N = 1, 100 and 77 leave ragged 32-key entries
K1_CASES = {"plain": (1, 128, False, False), "rope": (1, 200, True, False),
            "cls": (1, 128, False, True), "rope_cls": (1, 100, True, True),
            "one_token": (1, 1, True, True), "batch2": (2, 77, True, True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _k1_inputs(B, N, rope, cls, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    qkv = np.concatenate([rnd(B, N, 2 * C, s=QK_STD), rnd(B, N, C)], -1)
    tabs = ckv = None
    if rope:
        pos = jnp.asarray(rng.integers(0, 24, (B, N, 2)), jnp.int32)
        tabs = tuple(np.asarray(t) for t in rope2d_tables(pos, 64))
    if cls:
        ckv = (rnd(B, 1, C, s=QK_STD), rnd(B, 1, C))
    return qkv, tabs, ckv


@pytest.mark.parametrize("case", list(K1_CASES))
def test_tower_self_split_matches_pallas(case):
    B, N, rope, cls = K1_CASES[case]
    qkv, tabs, ckv = _k1_inputs(B, N, rope, cls, list(K1_CASES).index(case))
    j = (lambda x: None if x is None else tuple(map(jnp.asarray, x)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_ta._tower_fwd(jnp.asarray(qkv), j(tabs), j(ckv),
                                          64 ** -0.5))
    t = (lambda x: None if x is None else tuple(map(_t, x)))
    got = ta.tower_self_split_ref(_t(qkv), HEADS, t(tabs), t(ckv),
                                  matmul=matmul_tf32x3)
    assert got.shape == (B, N, C)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def _pairs(a, layout):
    """(B, P, N, 128) values as a contiguous tensor ("folded": the f32
    route folds (b, p) into the batch) or as the pair view of a (B, N,
    P·128) projection ("pairs": heads at stride 64)."""
    t = _t(a)
    if layout == "folded":
        return t.contiguous()
    B, P, N, D = t.shape
    return t.transpose(1, 2).contiguous().view(B, N, P, D).transpose(1, 2)


@pytest.mark.parametrize("layout", ["folded", "pairs"])
def test_packed_split_matches_pallas(layout):
    rng = np.random.default_rng(5)
    shape = (2, 2, 256, 128)
    q, k = (rng.standard_normal(shape).astype(np.float32) * 1.2
            for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_ab.packed_mha(*map(jnp.asarray, (q, k, v)),
                                          block_q=128, block_k=128))
    tq, tk, tv = (_pairs(a, layout) for a in (q, k, v))
    got = pa.packed_mha_split_ref(tq, tk, tv, matmul=matmul_tf32x3)
    # the output's storage: as the inputs' where their pair stride is not
    # 128, else (B, N, P, 128)
    assert got.stride(1) == (128 if layout == "pairs" else 256 * 128)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def test_self_views_pick_the_heads():
    """``self_views`` over the fused projection, at a storage offset too,
    picks exactly the heads ``split_heads`` picks from q, k and v."""
    B, N, H = 2, 5, 4
    base = torch.randn(3 + B * N * 3 * H * 64)
    qkv = base[3:].view(B, N, 3 * H * 64)
    for i, view in enumerate(ta.self_views(qkv, H)):
        want = ta._split_heads(qkv[..., i * H * 64:(i + 1) * H * 64], 64)
        assert view.stride() == (N * 3 * H * 64, 64, 3 * H * 64, 1)
        assert torch.equal(view, want), i


@pytest.mark.parametrize("layout", ["folded", "pairs"])
def test_head_views_pick_the_heads(layout):
    """``head_views`` of either layout picks head 2p + j of pair p at lanes
    64j:64(j + 1), as (B, 2P) heads or (B·P, 2)."""
    B, P, N = 2, 3, 4
    t = _pairs(np.random.default_rng(0).standard_normal(
        (B, P, N, 128)).astype(np.float32), layout)
    (view,) = pa.head_views(t)
    heads = t.reshape(B, P, N, 2, 64).transpose(2, 3)      # (B, P, 2, N, 64)
    want = heads.reshape(B * P, 2, N, 64) if layout == "folded" \
        else heads.reshape(B, 2 * P, N, 64)
    assert view.shape == want.shape and torch.equal(view, want)


def test_head_views_refuse_other_layouts():
    """A layout neither view takes raises before any launch, in the
    wrapper too (meta tensors: no card here)."""
    t = torch.randn(3, 2, 64, 128).transpose(0, 1)      # (B, P) swapped
    with pytest.raises(NotImplementedError):
        pa.head_views(t)
    q = torch.empty(3, 2, 64, 128, device="meta").transpose(0, 1)
    with pytest.raises(NotImplementedError):
        pa._packed_kernel(q, q, q, 0.125)
