"""K5 in bf16 without a card: its plain version ``flash_mha_bwd_ref`` (the
CPU path of ``flash_mha_bwd``) and the emulation of the bf16 Hopper
kernel's arithmetic (``flash_mha_bwd_split_ref`` on bf16 inputs: log2
units, dk and dv summed per fixed query split and the splits added in
order, the split of one query tile so that 130 queries take three)
against the JAX package's Pallas backward ``flash_bwd`` in bf16, in
interpret mode, from the same bf16 forward output and LSE (K4's plain
version in bf16).

Ragged shapes (Nq = 130, Nk = 200) at head dims 64 and 96.  Limit: at
most 0.5% of the bf16 gradient elements differ from the Pallas value,
and none by more than one bf16 ulp of the gradient's largest |value|.
The two sides differ in the order of their f32 sums and, where p or ds
sits within an f32 ulp or two of a bf16 rounding boundary (exp against
exp2, another exp), in which way that one value rounds: one term of a
sum then moves by a bf16 ulp of itself, and the terms reach the
gradient's largest magnitude.  An element that cancellation leaves near
0 shows that as many of its own ulps (the plain version itself: 88 ulps
of a 4.2e-5 dv element at ``bias``, D = 64, one ulp of the largest being
0.0156).  The CUDA kernel is held against the plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import flash_attention as t_fa
from panst3r_tpu.ops.pallas import flash_attention_bwd as j_bwd
from panst3r_tpu.ops.rope import rope2d_tables

NEG = float(np.finfo(np.float32).min)
B, H, NQ, NK = 1, 2, 130, 200
CASES = ("plain", "bias", "kv_valid", "rope")
MAX_DIFFERING = 0.005      # share of elements that may differ by one ulp


def _bf16(rng, *shape, s=1.0):
    """A bf16 torch tensor from numpy's normal draws."""
    x = (rng.standard_normal(shape) * s).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _jnp(t):
    """A torch tensor as a jnp array of the same dtype (bf16 exactly)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@functools.lru_cache(maxsize=None)
def _case(case: str, D: int):
    """bf16 q, k, v, do; K4's plain bf16 output and LSE; the bias, the key
    validity and the tables (torch); the Pallas gradients (f32 numpy)."""
    rng = np.random.default_rng(CASES.index(case) * 100 + D)
    # logits at a std of about 2 (peaked, as in trained attention)
    q, k = _bf16(rng, B, H, NQ, D, s=1.4), _bf16(rng, B, H, NK, D, s=1.4)
    v, do = _bf16(rng, B, H, NK, D), _bf16(rng, B, H, NQ, D)
    bias = kv_valid = rope = None
    if case == "bias":                 # dense, head-shared, with masked keys
        b = rng.standard_normal((B, 1, NQ, NK))
        bias = torch.from_numpy(np.where(rng.random(b.shape) < 0.3, NEG, b)
                                .astype(np.float32))
    if case == "kv_valid":
        valid = rng.random((B, NK)) > 0.2
        valid[:, 64:150] = False       # dead key tiles
        kv_valid = torch.from_numpy(valid)
    if case == "rope":
        pos = [jnp.asarray(rng.integers(0, 24, (B, n, 2)), jnp.int32)
               for n in (NQ, NK)]
        rope = tuple(torch.from_numpy(np.array(t)) for n in (0, 1)
                     for t in rope2d_tables(pos[n], D))
    kw = dict(bias=bias, kv_valid=kv_valid, rope=rope)
    o, lse = t_fa.flash_mha_ref(q, k, v, with_lse=True, **kw)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g.astype(jnp.float32)) for g in j_bwd.flash_bwd(
            *map(_jnp, (q, k, v, bias, kv_valid)),
            None if rope is None else tuple(map(_jnp, rope)),
            _jnp(o), _jnp(lse), _jnp(do), D ** -0.5)]
    return (q, k, v, o, lse, do), kw, want


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| > 0 (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _check_ulp(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        a, b = g.float(), torch.from_numpy(np.array(w, np.float32))
        diff = (a - b).abs()
        share = float((diff > 0).float().mean())
        assert share <= MAX_DIFFERING, (name, share)
        worst, ulp = float(diff.max()), _bf16_ulp(float(b.abs().max()))
        assert worst <= ulp, (name, worst, ulp)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_ref_bf16_matches_pallas(case, D):
    ins, kw, want = _case(case, D)
    n0 = t_fa.flash_mha_bwd.launches
    got = t_fa.flash_mha_bwd(*ins, **kw)
    assert t_fa.flash_mha_bwd.launches == n0      # the CPU runs no kernel
    _check_ulp(got, want)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_bf16_split_ref_matches_plain_and_pallas(case, D):
    """The bf16 kernel's arithmetic, with dkdv splits of one query tile
    (three splits merged in order), against the plain version and
    Pallas."""
    ins, kw, want = _case(case, D)
    assert t_fa.dkv_splits(NQ, 1) == 3
    got = t_fa.flash_mha_bwd_split_ref(*ins, split_tiles=1, **kw)
    _check_ulp(got, want)
    plain = t_fa.flash_mha_bwd_ref(*ins, **kw)
    _check_ulp(got, [t.float().numpy() for t in plain])
