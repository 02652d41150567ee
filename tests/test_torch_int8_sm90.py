"""The plain versions behind the bf16 Hopper kernels of K2-int8
(``csrc/tower_cross_int8_sm90.cu``) and K4 (``csrc/flash_fwd_bf16_sm90.cu``)
on the CPU, against the JAX package:

- ``tower_cross_int8_ref`` at the f32 kernel's 64-key tile against the
  Pallas ``kv_int8`` branch in interpret mode within 2e-5, on the shapes of
  tests/test_torch_int8.py (which holds the default, the bf16 kernel's
  128-key tile);
- the plain version of K2-int8's q pre-pass (``int8_qprep_ref``: q8 and
  c) bit for bit against the Pallas kernel's init step (:285-293) and the
  JAX package's table preparation (:483-497), in jnp;
- the magic-number int32 -> f32 conversion of the kernel's logits,
  emulated in torch, against ``float(s)`` for every |s| <= 64 * 127 * 127;
- the plain version of the bf16 K4's pre-pass (``bf16_prepass_ref``: q~
  and k~ rotated and rounded to bf16, unscaled; the key row in log2 units
  and the live tiles at the kernel's tile) against ``flash_mha_ref``'s
  rounding, the Pallas kernel's rotation and the key row's definition.

The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import panst3r_tpu.ops.pallas.flash_attention as jfa
import panst3r_tpu.ops.pallas.tower_attention as jta
from panst3r_torch.ops import flash_attention as fa
from panst3r_torch.ops import tower_attention as ta
from panst3r_tpu.ops.rope import rope2d_tables as j_tables

NEG = float(np.finfo(np.float32).min)
SCALE = 64 ** -0.5
LOG2E = np.float32(np.log2(np.e))


def _inputs(seed, B, Nq, Nk, C, bias):
    """As tests/test_torch_int8.py makes them."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Nq, C)) * 1.4).astype(np.float32)
    k = (rng.standard_normal((B, Nk, C)) * 1.4).astype(np.float32)
    v = rng.standard_normal((B, Nk, C)).astype(np.float32)
    if B == 2:
        k[1] *= 3.0
    tabs = [tuple(np.asarray(t) for t in j_tables(
        jnp.asarray(rng.integers(0, 32, (B, n, 2)), jnp.int32), 64))
        for n in (Nq, Nk)]
    kb = None
    if bias != "none":
        kb = np.zeros((B, Nk), np.float32)
        if bias in ("dead", "all"):
            kb[:, 64:260] = NEG
        if bias in ("inf", "all"):
            kb[:, -37:] = -np.inf
        if bias in ("soft", "all"):
            kb[:, 5:40] = -0.7
    return q, k, v, tabs[0], tabs[1], kb


def _t(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(map(_t, x))
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("B,Nq,Nk,C,bias", [
    (1, 256, 384, 128, "none"),
    (1, 200, 333, 256, "all"),
    (2, 130, 300, 128, "soft"),
    (1, 64, 700, 128, "inf"),
])
def test_int8_ref_at_f32_tile_matches_pallas(monkeypatch, B, Nq, Nk, C,
                                             bias):
    """At the f32 kernel's 64-key tile the plain int8 version equals the
    Pallas int8 branch within 2e-5, as at the default 128-key tile
    (tests/test_torch_int8.py): the tile moves only the stabilizer."""
    monkeypatch.setattr(jta, "_INT8_MIN_NQ", 0)
    q, k, v, qtab, ktab, kb = _inputs(Nq + Nk, B, Nq, Nk, C, bias)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jta._cross_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            tuple(map(jnp.asarray, qtab)), tuple(map(jnp.asarray, ktab)),
            None if kb is None else jnp.asarray(kb), SCALE, kv_int8=True))
    args = (_t(q), _t(k), _t(v), _t(qtab), _t(ktab), _t(kb))
    got = ta.tower_cross_int8_ref(*args, tile=ta.INT8_F32_TILE).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    wide = ta.tower_cross_int8_ref(*args).numpy()
    np.testing.assert_allclose(got, wide, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Nq,C,dtype", [
    (1, 200, 256, torch.float32), (2, 130, 128, torch.float32),
    (1, 97, 768, torch.bfloat16)])
def test_int8_qprep_ref_matches_pallas_init(B, Nq, C, dtype):
    """q8 and c of the plain pre-pass equal, bit for bit, what the Pallas
    kernel's init step computes from the tables the JAX package prepares
    (pair tables times scale·log2(e)·sk), in jnp on the same inputs."""
    q, k, _, qtab, ktab, _ = _inputs(B * Nq + C, B, Nq, 300, C, "none")
    q = torch.as_tensor(q).to(dtype)
    k8, (qcos, qsin) = ta.int8_prepare(_t(k), _t(qtab), _t(ktab), SCALE)
    q8, c = ta.int8_qprep_ref(q, qcos, qsin)
    assert q8.dtype == torch.int8 and c.dtype == torch.float32
    assert q8.shape == (B, Nq, C) and c.shape == (B, Nq, C // 128)

    # the JAX side: k rotated and quantized per tensor (:483-497), the q
    # tables tiled over the pair and scaled, then the init step per pair
    kf = jnp.asarray(k).reshape(B, 300, C // 128, 128)
    kt = [jnp.tile(jnp.asarray(t), (1, 1, 2))[:, :, None] for t in ktab]
    kr = kf * kt[0] + jta._rot2d_pair_nd(kf) * kt[1]
    sig_k = jnp.maximum(jnp.max(jnp.abs(kr)), 1e-20) / 127.0
    np.testing.assert_array_equal(
        k8.numpy(), np.asarray(jnp.round(kr / sig_k).astype(jnp.int8))
        .reshape(B, 300, C))
    sa = SCALE * float(np.log2(np.e))
    qt = [jnp.tile(jnp.asarray(t) * (sa * sig_k), (1, 1, 2)) for t in qtab]
    qj = jnp.asarray(q.float().numpy())
    for pair in range(C // 128):
        for b in range(B):
            qf = qj[b, :, 128 * pair:128 * (pair + 1)]
            qrot = qf * qt[0][b] + jta._rot2d_pair(qf) * qt[1][b]
            amax = jnp.maximum(jnp.max(jnp.abs(qrot), axis=-1,
                                       keepdims=True), 1e-20)
            np.testing.assert_array_equal(
                q8[b, :, 128 * pair:128 * (pair + 1)].numpy(),
                np.asarray(jnp.round(qrot * (127.0 / amax))
                           .astype(jnp.int8)))
            np.testing.assert_array_equal(
                c[b, :, pair].numpy(), np.asarray(amax * (1.0 / 127.0))[:, 0])


def _magic(s: torch.Tensor) -> torch.Tensor:
    """The kernel's conversion: the bits of 1.5·2^23 + s read as f32, less
    1.5·2^23 (``i2f_exact`` in csrc/tower_cross_int8_sm90.cu)."""
    return (s + 0x4B400000).view(torch.float32) - torch.tensor(
        12582912.0, dtype=torch.float32)


def test_magic_int_to_float_is_exact():
    """Exact for every score the kernel can see (|s| <= 64·127·127 =
    1,032,256: all of them), at the edges of its range (|s| < 2^22) and on
    a seeded sample."""
    top = 64 * 127 * 127
    assert top == 1_032_256
    every = torch.arange(-top, top + 1, dtype=torch.int32)
    assert torch.equal(_magic(every), every.to(torch.float32))
    edge = 2 ** 22 - 1
    ends = torch.tensor([-edge, -edge + 1, -1, 0, 1, edge - 1, edge],
                        dtype=torch.int32)
    assert torch.equal(_magic(ends), ends.to(torch.float32))
    rng = np.random.default_rng(8)
    sample = torch.as_tensor(rng.integers(-edge, edge + 1, 100_000,
                                          dtype=np.int32))
    assert torch.equal(_magic(sample), sample.to(torch.float32))


def _flash_inputs(case, D, B=2, H=3, Nq=130, Nk=333, seed=0):
    rng = np.random.default_rng(seed + D)
    q = torch.as_tensor(rng.standard_normal((B, H, Nq, D)) * 1.4,
                        dtype=torch.float32).to(torch.bfloat16)
    k = torch.as_tensor(rng.standard_normal((B, H, Nk, D)) * 1.4,
                        dtype=torch.float32).to(torch.bfloat16)
    bias = kv_valid = rope = None
    if case in ("kv_valid", "masked_rows"):
        valid = rng.random((B, Nk)) > 0.2
        valid[0, 64:200] = False                # dead key tiles
        if case == "masked_rows":
            valid[1] = False
        kv_valid = torch.as_tensor(valid)
    if case == "key_bias":
        b = rng.standard_normal((B, 1, 1, Nk)).astype(np.float32)
        b[..., 20:150] = NEG
        bias = torch.as_tensor(b)
    if case == "rope":
        rope = tuple(torch.as_tensor(np.array(t)) for n in (Nq, Nk)
                     for t in j_tables(jnp.asarray(
                         rng.integers(0, 40, (B, n, 2)), jnp.int32), D))
    return q, k, bias, kv_valid, rope


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", ["plain", "kv_valid", "key_bias", "rope",
                                  "masked_rows"])
def test_bf16_prepass_ref(D, case):
    """q~ and k~ equal ``flash_mha_ref``'s rotated bf16 q and k bit for bit
    (unscaled) and the Pallas kernel's rotation (:88-97, jnp) within one
    bf16 rounding; the key row in log2 units and the live tiles follow
    the row's definition at the kernel's tile (128 keys at d=64, 64 at
    d=96)."""
    B, Nk = 2, 333
    q, k, bias, kv_valid, rope = _flash_inputs(case, D)
    qt, kt, bl, tiles = fa.bf16_prepass_ref(q, k, bias, kv_valid, rope)
    rq, rk, _ = fa._logits(q, k, bias, kv_valid, rope, D ** -0.5)
    assert qt.dtype == kt.dtype == torch.bfloat16
    assert torch.equal(qt, rq) and torch.equal(kt, rk)
    if rope is None:
        assert torch.equal(qt, q) and torch.equal(kt, k)
    else:
        for x, y, (cs, sn) in ((q, qt, rope[:2]), (k, kt, rope[2:])):
            xf = jnp.asarray(x.float().numpy())
            want = (xf * jnp.asarray(cs.numpy())[:, None]
                    + jfa._rot2d(xf, D) * jnp.asarray(sn.numpy())[:, None])
            got = y.float().numpy()
            ulp = np.abs(np.asarray(want)) * 2.0 ** -8 + 1e-30
            assert (np.abs(got - np.asarray(want)) <= ulp).all()
    tile = {64: 128, 96: 64}[D]
    assert fa.BF16_KEY_TILE[D] == tile
    nt = -(-Nk // tile)
    assert bl.shape == (B, nt * tile)
    row = np.zeros((B, Nk), np.float32)
    if bias is not None:
        row += bias[:, 0, 0].numpy()
    if kv_valid is not None:
        row += np.where(kv_valid.numpy(), 0.0, NEG).astype(np.float32)
    live = np.full((B, nt * tile), False)
    live[:, :Nk] = row > NEG / 2
    want_bl = np.full((B, nt * tile), NEG, np.float32)
    with np.errstate(over="ignore"):      # a dead key's row * log2(e)
        want_bl[:, :Nk] = np.where(live[:, :Nk], row * LOG2E, NEG)
    np.testing.assert_array_equal(bl.numpy(), want_bl)
    assert tiles == [list(np.flatnonzero(r.reshape(nt, tile).any(-1)))
                     for r in live]
    if case == "masked_rows":
        assert tiles[1] == []
