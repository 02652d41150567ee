"""K1-K3 CUDA kernels against their plain versions at edge shapes (ragged
tiles, dead key tiles, rows with no live key), f32 and bf16, with the
limits of chip_smoke.py.  Needs a CUDA card; skips without one.  On the
card (no JAX there, so without the repo's conftest):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import F32_TOL, QK_STD, bf16_check
from panst3r_torch.ops import masked_attention as ma
from panst3r_torch.ops import tower_attention as ta
from panst3r_torch.ops.rope import rope2d_tables

pytestmark = pytest.mark.cuda
NEG = float(np.finfo(np.float32).min)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, dev, dtype, *shape, s=1.0):
    return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)


def _f32(x):
    if isinstance(x, tuple):
        return tuple(map(_f32, x))
    return x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 \
        else x


def _close(out, plain, *args):
    """Hold the kernel's ``out`` against ``plain(*args)``."""
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ref = plain(*args).float()
    if out.dtype == torch.float32:
        err = (out - ref).abs().max().item()
        assert err <= F32_TOL, err
    else:
        check = bf16_check(out.float(), ref, plain(*map(_f32, args)).float())
        assert check["ok"], check


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C,rope,cls", [
    (1, 1, 128, False, False), (2, 100, 128, True, False),
    (3, 200, 256, False, True), (2, 1024, 768, True, True)])
def test_tower_self_kernel(dev, dtype, B, N, C, rope, cls):
    g = torch.Generator(device=dev).manual_seed(N)
    qkv = torch.cat([_rnd(g, dev, dtype, B, N, 2 * C, s=QK_STD),
                     _rnd(g, dev, dtype, B, N, C)], -1)
    pos = torch.randint(0, 40, (B, N, 2), generator=g, device=dev)
    tabs = rope2d_tables(pos, 64) if rope else None
    ckv = ((_rnd(g, dev, dtype, B, 1, C, s=QK_STD),
            _rnd(g, dev, dtype, B, 1, C))
           if cls else None)
    n0 = ta.tower_self_attention.launches
    out = ta.tower_self_attention(qkv, C // 64, tabs=tabs, cls_kv=ckv)
    assert ta.tower_self_attention.launches == n0 + 1
    _close(out, ta.tower_self_attention_ref, qkv, C // 64, tabs, ckv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Nq,Nk,rope,bias", [
    (1, 70, 130, True, "none"), (2, 300, 1000, True, "dead_tiles"),
    (2, 64, 257, False, "row_dead"), (1, 1, 64, True, "random")])
def test_tower_cross_kernel(dev, dtype, B, Nq, Nk, rope, bias):
    g = torch.Generator(device=dev).manual_seed(Nq + Nk)
    C = 128
    q = _rnd(g, dev, dtype, B, Nq, C, s=QK_STD)
    k = _rnd(g, dev, dtype, B, Nk, C, s=QK_STD)
    v = _rnd(g, dev, dtype, B, Nk, C)
    qtab = ktab = None
    if rope:
        qtab = rope2d_tables(torch.randint(0, 40, (B, Nq, 2), generator=g,
                                           device=dev), 64)
        ktab = rope2d_tables(torch.randint(0, 40, (B, Nk, 2), generator=g,
                                           device=dev), 64)
    kb = None
    if bias != "none":
        valid = torch.rand(B, Nk, generator=g, device=dev) > 0.3
        if bias == "dead_tiles":
            valid[:, 64:640] = False
        if bias == "row_dead":
            valid[1] = False                  # batch 1 sees no key at all
        kb = torch.where(valid, 0.0, NEG)
    out = ta.tower_cross_attention(q, k, v, qtab, ktab, kb)
    _close(out, ta.tower_cross_attention_ref, q, k, v, qtab, ktab, kb)
    if bias == "row_dead":
        assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Nq,Nk", [
    (1, 8, 200, 3072), (2, 2, 1, 100), (1, 3, 130, 700)])
def test_masked_attn_kernel(dev, dtype, B, H, Nq, Nk):
    D = 96
    g = torch.Generator(device=dev).manual_seed(Nq + Nk)
    q = _rnd(g, dev, dtype, B, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dtype, B, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dtype, B, H, Nk, D)
    blocked = torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.05
    blocked[:, :, : Nk // 3] = True               # dead key tiles
    blocked[:, Nq // 2] = True                    # a row with no live key
    out = ma.masked_mha(q, k, v, blocked)
    _close(out, ma.masked_mha_ref, q, k, v, blocked)
    assert (out[:, :, Nq // 2] == 0).all()


def test_unsupported_shapes_raise(dev):
    blocked = torch.zeros(1, 8, 8, dtype=torch.bool, device=dev)
    for D in (32, 64, 128):                       # K3 is built for D=96
        q = torch.zeros(1, 2, 8, D, device=dev)
        with pytest.raises(NotImplementedError, match="head dim 96"):
            ma.masked_mha(q, q, q, blocked)
    qkv = torch.zeros(1, 8, 3 * 256, device=dev)
    with pytest.raises(NotImplementedError):
        ta.tower_self_attention(qkv, 2)           # d=128 heads
    with pytest.raises(TypeError):
        ta.tower_self_attention(qkv.half(), 4)
