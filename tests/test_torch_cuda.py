"""K1-K6 and K2-int8 CUDA kernels against their plain versions at edge
shapes (ragged tiles, dead key tiles, rows with no live key, -inf keys,
strided views, the train step's shapes), f32 and bf16, with the limits
of chip_smoke.py; K1, K2 and K3 on the Hopper engines (bf16; f32 K1, K2
and K3) batch-invariant bit for bit (bf16 K1, K2 also over query
chunks), and so the f32 K4 and K5 (K4 and K5's dq also over query
ranges), whose bits are also held to a recorded digest; K1, K2, K3,
K4, K5 and K6 routed by dtype; the int8 gate's
launches; gradients through K1-K4 on the card against the plain versions';
a small v2 train step and small v1 serve wires on the card against the
CPU; FLOP counts on the card equal to the CPU's; K2 and K3 at
``serve_many_device``'s batch of two scenes, and ``serve_many_device``
against ``serve_device`` per scene at depth 2; the checkpoint verifier's
``card_parity`` and ``forward`` stages with their launches.  Needs a CUDA card; skips without one.  On the card (no JAX there, so
without the repo's conftest):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import F32_TOL, QK_STD, bf16_check
from panst3r_torch.ops import flash_attention as fa
from panst3r_torch.ops.image import image_cast
from panst3r_torch.ops import masked_attention as ma
from panst3r_torch.ops import packed_attention as pa
from panst3r_torch.ops import tower_attention as ta
from panst3r_torch.ops.rope import rope2d_tables

pytestmark = pytest.mark.cuda
NEG = float(np.finfo(np.float32).min)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False     # f32 convolutions in f32
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
    (3, 200, 256, False, True), (2, 1024, 768, True, True),
    (1, 768, 768, True, False),           # memory build: 64-row CTAs
    (4, 768, 1024, True, False),          # encoder: 128-row CTAs
    (4, 768, 1024, False, True)])         # DINO's cls column
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


def _memory_bias(B, Nk, valid_slots, capacity, dev):
    """A memory-build key bias: ``valid_slots`` of ``capacity`` slots
    valid, then the update's own tokens (all valid)."""
    valid = torch.ones(B, Nk, dtype=torch.bool, device=dev)
    valid[:, valid_slots:capacity] = False
    return torch.where(valid, 0.0, NEG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Nq,Nk,rope,bias", [
    (1, 70, 130, True, "none"), (2, 300, 1000, True, "dead_tiles"),
    (2, 64, 257, False, "row_dead"), (1, 1, 64, True, "random"),
    (1, 768, 13056, True, "update_long"),   # serve_long's last update
    (2, 300, 2950, True, "dead_tiles"),     # ragged Nk, two splits
    (2, 200, 2950, False, "neg_inf"),       # -inf keys and a -inf tile
    # train_v2's first memory update (no memory slot valid yet) and its
    # render, with fewer query rows
    (2, 1536, 5376, True, "update_train"),
    (2, 1000, 3840, True, "none")])
def test_tower_cross_kernel(dev, dtype, B, Nq, Nk, rope, bias):
    g = torch.Generator(device=dev).manual_seed(Nq + Nk)
    C = 768 if bias in ("update_long", "update_train") else 128
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
        if bias == "update_long":
            kb = _memory_bias(B, Nk, 11520, 12288, dev)
        if bias == "update_train":
            kb = _memory_bias(B, Nk, 0, 3840, dev)
        if bias == "neg_inf":
            kb[:, -3:] = -float("inf")
            kb[:, 128:256] = -float("inf")    # a whole tile at -inf
    out = ta.tower_cross_attention(q, k, v, qtab, ktab, kb)
    _close(out, ta.tower_cross_attention_ref, q, k, v, qtab, ktab, kb)
    if bias == "row_dead":
        assert (out[1] == 0).all()


def test_tower_kernels_batch_and_chunk_invariant(dev):
    """bf16 K1 and K2 on the Hopper engine: the rows of batch b, and (K2)
    query rows [a, a + n), equal the slice of the full call bit for bit,
    though the slices run other grids, 64- instead of 128-row CTAs
    (``ta.cta_warpgroups``) and, for K2, other batches' split counts; two
    runs of one call are bit-equal."""
    g = torch.Generator(device=dev).manual_seed(7)
    dt = torch.bfloat16
    B, N, C = 4, 768, 768
    qkv = torch.cat([_rnd(g, dev, dt, B, N, 2 * C, s=QK_STD),
                     _rnd(g, dev, dt, B, N, C)], -1)
    tabs = rope2d_tables(torch.randint(0, 40, (B, N, 2), generator=g,
                                       device=dev), 64)
    full = ta.tower_self_attention(qkv, C // 64, tabs=tabs)
    assert torch.equal(full, ta.tower_self_attention(qkv, C // 64,
                                                     tabs=tabs))
    assert ta.cta_warpgroups(B, C // 64, N) == 2
    assert ta.cta_warpgroups(1, C // 64, N) == 1
    for b in range(B):
        part = ta.tower_self_attention(
            qkv[b:b + 1].contiguous(), C // 64,
            tabs=tuple(t[b:b + 1].contiguous() for t in tabs))
        assert torch.equal(part, full[b:b + 1]), b

    Nq, Nk = 768, 2950                  # 24 key tiles: up to two splits
    q = _rnd(g, dev, dt, B, Nq, C, s=QK_STD)
    k = _rnd(g, dev, dt, B, Nk, C, s=QK_STD)
    v = _rnd(g, dev, dt, B, Nk, C)
    qtab, ktab = (rope2d_tables(torch.randint(0, 40, (B, n, 2), generator=g,
                                              device=dev), 64)
                  for n in (Nq, Nk))
    valid = torch.ones(B, Nk, dtype=torch.bool, device=dev)
    valid[1, 1000:] = False             # 8 live tiles: one split
    valid[2] = False                    # no live key: zeros
    valid[3, 640:1600] = False          # dead tiles inside, two splits
    kb = torch.where(valid, 0.0, NEG)
    kb[0, -3:] = -float("inf")
    full = ta.tower_cross_attention(q, k, v, qtab, ktab, kb)
    assert torch.equal(full, ta.tower_cross_attention(q, k, v, qtab, ktab,
                                                      kb))
    assert (full[2] == 0).all()
    for b in range(B):
        sl = slice(b, b + 1)
        part = ta.tower_cross_attention(
            q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous(),
            tuple(t[sl].contiguous() for t in qtab),
            tuple(t[sl].contiguous() for t in ktab), kb[sl].contiguous())
        assert torch.equal(part, full[sl]), b
    for a, n in ((0, 100), (100, 668), (37, 1)):
        rows = slice(a, a + n)
        part = ta.tower_cross_attention(
            q[:, rows].contiguous(), k, v,
            tuple(t[:, rows].contiguous() for t in qtab), ktab, kb)
        assert torch.equal(part, full[:, rows]), (a, n)
    assert ta.cta_warpgroups(1, C // 64, 100, ta.max_splits(Nk)) == 1


@pytest.mark.parametrize("rope,cls", [(True, True), (False, False)])
def test_tower_self_f32_batch_invariant(dev, rope, cls):
    """The f32 K1 on the 3xTF32 engine (q through a tensor map over qkv
    itself without tables, over the rotated copy with them; the cls key
    one more row of the planes): two calls give the same bits, and the
    rows of batch b equal the slice of the full call bit for bit, though
    the slice runs another grid."""
    g = torch.Generator(device=dev).manual_seed(19)
    dt = torch.float32
    B, N, C = 3, 300, 256
    qkv = torch.cat([_rnd(g, dev, dt, B, N, 2 * C, s=QK_STD),
                     _rnd(g, dev, dt, B, N, C)], -1)
    tabs = rope2d_tables(torch.randint(0, 40, (B, N, 2), generator=g,
                                       device=dev), 64) if rope else None
    ckv = (_rnd(g, dev, dt, B, 1, C, s=QK_STD),
           _rnd(g, dev, dt, B, 1, C)) if cls else None
    full = ta.tower_self_attention(qkv, C // 64, tabs=tabs, cls_kv=ckv)
    assert torch.equal(full, ta.tower_self_attention(qkv, C // 64,
                                                     tabs=tabs, cls_kv=ckv))
    _close(full, ta.tower_self_attention_ref, qkv, C // 64, tabs, ckv)
    for b in range(B):
        sl = slice(b, b + 1)
        part = ta.tower_self_attention(
            qkv[sl].contiguous(), C // 64,
            tabs=None if tabs is None else tuple(t[sl].contiguous()
                                                 for t in tabs),
            cls_kv=None if ckv is None else tuple(t[sl].contiguous()
                                                  for t in ckv))
        assert torch.equal(part, full[sl]), b


@pytest.mark.parametrize("op", ["self", "cross"])
def test_tower_kernels_route_by_dtype(dev, monkeypatch, op):
    """bf16 runs the Hopper library; f32 runs the 3xTF32 engine: K1 the
    f32 K4's library (its main kernel over views of qkv), K2 its own
    Hopper library; the wrapper counts one launch per call either way (the
    Hopper libraries make several CUDA launches), and ``launches_f32`` the
    f32 ones."""
    from panst3r_torch.ops import cuda_build

    names = []
    real = cuda_build.function

    def recording(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(cuda_build, "function", recording)
    g = torch.Generator(device=dev).manual_seed(3)
    counter = getattr(ta, f"tower_{op}_attention")
    for dtype, lib in ((torch.bfloat16, f"tower_{op}_sm90"),
                       (torch.float32, "flash_fwd_sm90" if op == "self"
                        else "tower_cross_sm90")):
        n0, f0 = counter.launches, counter.launches_f32
        if op == "self":
            qkv = _rnd(g, dev, dtype, 2, 300, 3 * 128)
            tabs = rope2d_tables(torch.randint(0, 40, (2, 300, 2),
                                               generator=g, device=dev), 64)
            ta.tower_self_attention(qkv, 2, tabs=tabs)
        else:
            q = _rnd(g, dev, dtype, 1, 300, 128)
            k = _rnd(g, dev, dtype, 1, 2950, 128)
            ta.tower_cross_attention(q, k, k, kv_bias=torch.zeros(
                1, 2950, device=dev))
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1
        assert counter.launches_f32 == f0 + (dtype == torch.float32)
        assert names[-1] == lib, names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Nq,Nk", [
    (1, 8, 200, 3072), (2, 2, 1, 100), (1, 3, 130, 700),
    (1, 8, 200, 12288),                   # serve_long: 16 keyframes
    (2, 8, 200, 3840)])                   # train_v2: B=2 x 5 views
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 48, 80, 128])
def test_masked_attn_kernel_head_dims(dev, dtype, D):
    """K3 at head dims padded to 96 and at 128 (its two instantiations)
    against its plain version, with dead key tiles, a row with no live key
    and more than one split; the gradients (the plain formula's, as at D
    = 96) bit-equal to autograd through the dense masked attention."""
    from panst3r_torch.ops.attention import dot_product_attention

    B, H, Nq, Nk = 1, 3, 130, 700
    g = torch.Generator(device=dev).manual_seed(D)
    q = _rnd(g, dev, dtype, B, H, Nq, D, s=QK_STD).requires_grad_()
    k = _rnd(g, dev, dtype, B, H, Nk, D, s=QK_STD).requires_grad_()
    v = _rnd(g, dev, dtype, B, H, Nk, D).requires_grad_()
    blocked = torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.05
    blocked[:, :, : Nk // 3] = True
    blocked[:, Nq // 2] = True
    n0 = ma.masked_mha.launches
    out = ma.masked_mha(q, k, v, blocked)
    assert ma.masked_mha.launches == n0 + 1 and out.shape == q.shape
    _close(out.detach(), ma.masked_mha_ref, q.detach(), k.detach(),
           v.detach(), blocked)
    assert (out[:, :, Nq // 2] == 0).all()
    cot = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), cot)
    want = torch.autograd.grad(dot_product_attention(
        q, k, v, mask=~blocked[:, None]), (q, k, v), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 48, 128])
def test_flash_padded_autograd(dev, dtype, D):
    """K4 + K5 through autograd at padded head dims and at 128, with RoPE
    tables: f32 within 1e-4 of the gradient's max against autograd
    through ``flash_mha_ref``; bf16 by the bf16 rule against the plain
    versions' chain in bf16 and in f32."""
    g = torch.Generator(device=dev).manual_seed(D + 3)
    q, k, v, _, _, rope = _flash_inputs(g, dev, dtype, "rope", D)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    cot = _rnd(g, dev, dtype, *q.shape)
    n0, b0 = fa.flash_mha.launches, fa.flash_mha_bwd.launches
    got = torch.autograd.grad(fa.flash_mha(q, k, v, rope=rope), (q, k, v),
                              cot)
    assert fa.flash_mha.launches == n0 + 1
    assert fa.flash_mha_bwd.launches == b0 + 2
    if dtype == torch.float32:
        want = torch.autograd.grad(fa.flash_mha_ref(q, k, v, rope=rope),
                                   (q, k, v), cot)
        for a, b in zip(got, want):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()
        return

    def chain(q, k, v, do):
        o, lse = fa.flash_mha_ref(q, k, v, rope=rope, with_lse=True)
        return fa.flash_mha_bwd_ref(q, k, v, o, lse, do, rope=rope)

    ins = [t.detach() for t in (q, k, v, cot)]
    check = chip_smoke._grad_check(got, chain(*ins),
                                   chain(*(t.float() for t in ins)), dtype)
    assert all(c["ok"] and c["finite"] for c in check.values()), check


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,N,D", [(16, 1200, 64), (2, 768, 16)])
def test_split_cls_on_card(dev, dtype, H, N, D):
    """``flash_attention_split_cls`` on the card (K4 with its LSE over the
    patches, the cls column merged) against its concatenated plain
    version on the same inputs: DINO-L's 1200 patches at 480x640, and the
    tiny presets' DINO (2 heads of 16); one K4 launch; the gradients
    (the plain version's, recomputed) bit-equal to autograd through it."""
    from panst3r_torch.ops.attention import (_split_cls_ref,
                                             flash_attention_split_cls)

    B = 2
    g = torch.Generator(device=dev).manual_seed(N + D)
    q, k = (_rnd(g, dev, dtype, B, H, N, D, s=QK_STD).requires_grad_()
            for _ in range(2))
    v = _rnd(g, dev, dtype, B, H, N, D).requires_grad_()
    qc, kc = (_rnd(g, dev, dtype, B, H, 1, D, s=QK_STD).requires_grad_()
              for _ in range(2))
    vc = _rnd(g, dev, dtype, B, H, 1, D).requires_grad_()
    ins = (q, k, v, qc, kc, vc)
    n0 = fa.flash_mha.launches
    out = flash_attention_split_cls(*ins)
    assert fa.flash_mha.launches == n0 + 1
    scale = D ** -0.5
    plain = [t.detach() for t in ins]
    for i in range(2):
        _close(out[i].detach(),
               lambda *a: _split_cls_ref(*a, scale)[i], *plain)
    cots = [torch.randn(o.shape, generator=g, device=dev).to(dtype)
            for o in out]
    got = torch.autograd.grad(out, ins, cots)
    want = torch.autograd.grad(_split_cls_ref(*ins, scale), ins, cots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_masked_attn_batch_invariant(dev):
    """bf16 K3 on the Hopper engine: each batch element's rows equal the
    slice of the full call bit for bit, though the batches' query blocks
    take one split, several or none; two runs of one call are
    bit-equal."""
    g = torch.Generator(device=dev).manual_seed(11)
    dt = torch.bfloat16
    B, H, Nq, Nk, D = 3, 8, 200, 3072, 96
    q = _rnd(g, dev, dt, B, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dt, B, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dt, B, H, Nk, D)
    blocked = torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.05
    blocked[0, :, 500:] = True          # 8 live key blocks: one split
    blocked[1, :, :1000] = True         # several splits
    blocked[2, :64] = True              # a query block with no live key
    full = ma.masked_mha(q, k, v, blocked)
    assert torch.equal(full, ma.masked_mha(q, k, v, blocked))
    assert (full[2, :, :64] == 0).all()
    for b in range(B):
        sl = slice(b, b + 1)
        part = ma.masked_mha(q[sl].contiguous(), k[sl].contiguous(),
                             v[sl].contiguous(), blocked[sl].contiguous())
        assert torch.equal(part, full[sl]), b


def test_f32_kernels_batch_and_chunk_invariant(dev):
    """f32 K2 and K3 on the 3xTF32 engine: the rows of batch b, and (K2)
    query rows [a, a + n), equal the slice of the full call bit for bit,
    though the slices run other grids and other batches' split counts; two
    runs of one call are bit-equal; rows with no live key are 0."""
    g = torch.Generator(device=dev).manual_seed(13)
    dt = torch.float32
    B, Nq, Nk, C = 4, 768, 2950, 768    # 24 key tiles: up to two splits
    q = _rnd(g, dev, dt, B, Nq, C, s=QK_STD)
    k = _rnd(g, dev, dt, B, Nk, C, s=QK_STD)
    v = _rnd(g, dev, dt, B, Nk, C)
    qtab, ktab = (rope2d_tables(torch.randint(0, 40, (B, n, 2), generator=g,
                                              device=dev), 64)
                  for n in (Nq, Nk))
    valid = torch.ones(B, Nk, dtype=torch.bool, device=dev)
    valid[1, 1000:] = False             # 8 live tiles: one split
    valid[2] = False                    # no live key: zeros
    valid[3, 640:1600] = False          # dead tiles inside, two splits
    kb = torch.where(valid, 0.0, NEG)
    kb[0, -3:] = -float("inf")
    full = ta.tower_cross_attention(q, k, v, qtab, ktab, kb)
    assert torch.equal(full, ta.tower_cross_attention(q, k, v, qtab, ktab,
                                                      kb))
    assert (full[2] == 0).all()
    _close(full, ta.tower_cross_attention_ref, q, k, v, qtab, ktab, kb)
    for b in range(B):
        sl = slice(b, b + 1)
        part = ta.tower_cross_attention(
            q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous(),
            tuple(t[sl].contiguous() for t in qtab),
            tuple(t[sl].contiguous() for t in ktab), kb[sl].contiguous())
        assert torch.equal(part, full[sl]), b
    for a, n in ((0, 100), (100, 668), (37, 1)):
        rows = slice(a, a + n)
        part = ta.tower_cross_attention(
            q[:, rows].contiguous(), k, v,
            tuple(t[:, rows].contiguous() for t in qtab), ktab, kb)
        assert torch.equal(part, full[:, rows]), (a, n)

    B, H, Nq, Nk, D = 3, 8, 200, 3072, 96
    q = _rnd(g, dev, dt, B, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dt, B, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dt, B, H, Nk, D)
    blocked = torch.rand(B, Nq, Nk, generator=g, device=dev) > 0.05
    blocked[0, :, 500:] = True          # 8 live key blocks: one split
    blocked[1, :, :1000] = True         # several splits
    blocked[2, :64] = True              # a query block with no live key
    blocked[1, 99] = True               # a fully blocked row
    full = ma.masked_mha(q, k, v, blocked)
    assert torch.equal(full, ma.masked_mha(q, k, v, blocked))
    assert (full[2, :, :64] == 0).all() and (full[1, :, 99] == 0).all()
    _close(full, ma.masked_mha_ref, q, k, v, blocked)
    for b in range(B):
        sl = slice(b, b + 1)
        part = ma.masked_mha(q[sl].contiguous(), k[sl].contiguous(),
                             v[sl].contiguous(), blocked[sl].contiguous())
        assert torch.equal(part, full[sl]), b


@pytest.mark.parametrize("op", ["masked", "packed"])
def test_k3_k6_route_by_dtype(dev, monkeypatch, op):
    """bf16 K3 and K6 run their Hopper libraries; f32 K3 runs its Hopper
    library too (the 3xTF32 engine), f32 K6 the f32 K4's library (its main
    kernel over the heads as views); the wrapper counts one launch per call
    either way, and ``launches_f32`` the f32 ones."""
    from panst3r_torch.ops import cuda_build

    names = []
    real = cuda_build.function

    def recording(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(cuda_build, "function", recording)
    g = torch.Generator(device=dev).manual_seed(5)
    counter = ma.masked_mha if op == "masked" else pa.packed_mha
    lib = "masked_attn" if op == "masked" else "packed_flash"
    for dtype, want in ((torch.bfloat16, lib + "_sm90"),
                        (torch.float32, "masked_attn_sm90" if op == "masked"
                         else "flash_fwd_sm90")):
        n0, f0 = counter.launches, counter.launches_f32
        if op == "masked":
            q = _rnd(g, dev, dtype, 1, 2, 100, 96)
            k = _rnd(g, dev, dtype, 1, 2, 700, 96)
            ma.masked_mha(q, k, k, torch.rand(1, 100, 700, generator=g,
                                              device=dev) > 0.5)
        else:
            q = _rnd(g, dev, dtype, 1, 2, 128, 128)
            pa.packed_mha(q, q, q)
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1
        assert counter.launches_f32 == f0 + (dtype == torch.float32)
        assert names[-1] == want, names


def test_unsupported_shapes_raise(dev):
    """K1 refuses heads not of 64 and half floats.  (K3 at D = 160 and 256,
    which it refused up to 128, runs the wide-head engine: held against
    its plain version here, with the wide launch counter.)"""
    g = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for D in (160, 256):
            q = _rnd(g, dev, dtype, 1, 2, 90, D, s=QK_STD)
            k = _rnd(g, dev, dtype, 1, 2, 300, D, s=QK_STD)
            v = _rnd(g, dev, dtype, 1, 2, 300, D)
            blocked = torch.rand(1, 90, 300, generator=g, device=dev) > 0.4
            n0, w0 = ma.masked_mha.launches, ma.masked_mha.launches_wide
            f0 = ma.masked_mha.launches_wide_f32
            out = ma.masked_mha(q, k, v, blocked)
            assert ma.masked_mha.launches == n0
            assert ma.masked_mha.launches_wide == w0 + 1
            assert ma.masked_mha.launches_wide_f32 == \
                f0 + (dtype == torch.float32)
            _close(out, ma.masked_mha_ref, q, k, v, blocked)
    qkv = torch.zeros(1, 8, 3 * 256, device=dev)
    with pytest.raises(NotImplementedError):
        ta.tower_self_attention(qkv, 2)           # d=128 heads
    with pytest.raises(TypeError):
        ta.tower_self_attention(qkv.half(), 4)


def _flash_inputs(g, dev, dtype, case, D, B=2, H=3, Nq=130, Nk=333):
    q = _rnd(g, dev, dtype, B, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dtype, B, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dtype, B, H, Nk, D)
    if case == "strided":                 # split-heads views of (B, N, H*D)
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    bias = kv_valid = rope = None
    if case in ("dense_bias", "bias_and_kv_valid"):
        b = torch.randn(B, H, Nq, Nk, generator=g, device=dev)
        bias = torch.where(torch.rand(B, H, Nq, Nk, generator=g, device=dev)
                           < 0.2, NEG, b)
    if case == "head_shared_bias":
        bias = torch.where(torch.rand(B, 1, Nq, Nk, generator=g, device=dev)
                           < 0.5, NEG, 0.0)
    if case in ("kv_valid", "bias_and_kv_valid", "masked_rows"):
        kv_valid = torch.rand(B, Nk, generator=g, device=dev) > 0.2
        kv_valid[0, 64:200] = False       # dead key tiles
        if case == "masked_rows":
            kv_valid[1] = False           # batch 1 sees no key at all
    if case == "key_bias":
        bias = torch.randn(B, 1, 1, Nk, generator=g, device=dev)
        bias[..., 20:150] = NEG
    if case == "rope":
        rope = (*rope2d_tables(torch.randint(0, 40, (B, Nq, 2), generator=g,
                                             device=dev), D),
                *rope2d_tables(torch.randint(0, 40, (B, Nk, 2), generator=g,
                                             device=dev), D))
    return q, k, v, bias, kv_valid, rope


# the instantiated head dims, then dims padded to them (the tiny presets'
# 8, 12, 16; 48 and 80) and D = 128
FLASH_DIMS = [64, 96, 8, 12, 16, 48, 80, 128]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", FLASH_DIMS)
@pytest.mark.parametrize("case", [
    "plain", "dense_bias", "head_shared_bias", "kv_valid", "key_bias",
    "bias_and_kv_valid", "rope", "masked_rows", "strided"])
def test_flash_fwd_kernel(dev, dtype, D, case):
    """K4's output against its plain version (chip_smoke.py limits) and its
    LSE within 1e-4 relative (f32 logits on both sides)."""
    g = torch.Generator(device=dev).manual_seed(D)
    args = _flash_inputs(g, dev, dtype, case, D)
    n0 = fa.flash_mha.launches
    out, lse = fa.flash_mha(*args, with_lse=True)
    assert fa.flash_mha.launches == n0 + 1

    def plain(*a):
        return fa.flash_mha_ref(*a)

    _close(out, plain, *args)
    ref_lse = fa.flash_mha_ref(*args, with_lse=True)[1]
    assert (lse - ref_lse).abs().max().item() \
        <= 1e-4 * (1 + ref_lse.abs().max().item())
    if case == "masked_rows":
        assert (out[1] == 0).all() and (lse[1] == NEG).all()


def test_flash_unsupported_inputs_raise(dev):
    """K4 refuses half floats.  (K4 and K5 at D = 160 and 256, which they
    refused up to 128, run the wide-head engine: held against their plain
    versions here, with the wide launch counters.)"""
    g = torch.Generator(device=dev).manual_seed(8)
    for dtype in (torch.float32, torch.bfloat16):
        for D in (160, 256):
            q, k, v, _, kv_valid, _ = _flash_inputs(g, dev, dtype,
                                                    "kv_valid", D)
            do = _rnd(g, dev, dtype, *q.shape)
            n0, w0 = fa.flash_mha.launches, fa.flash_mha.launches_wide
            f0 = fa.flash_mha.launches_wide_f32
            o, lse = fa.flash_mha(q, k, v, kv_valid=kv_valid, with_lse=True)
            assert fa.flash_mha.launches == n0
            assert fa.flash_mha.launches_wide == w0 + 1
            assert fa.flash_mha.launches_wide_f32 == \
                f0 + (dtype == torch.float32)
            _close(o, lambda *a: fa.flash_mha_ref(*a, kv_valid=kv_valid),
                   q, k, v)
            b0, bw0 = fa.flash_mha_bwd.launches, \
                fa.flash_mha_bwd.launches_wide
            got = fa.flash_mha_bwd(q, k, v, o, lse, do, kv_valid=kv_valid)
            assert fa.flash_mha_bwd.launches == b0
            assert fa.flash_mha_bwd.launches_wide == bw0 + 2
            torch.cuda.synchronize()
            plain = fa.flash_mha_bwd_ref(q, k, v, o, lse, do,
                                         kv_valid=kv_valid)
            exact = fa.flash_mha_bwd_ref(*_f32((q, k, v, o)), lse, _f32(do),
                                         kv_valid=kv_valid)
            check = chip_smoke._grad_check(got, plain, exact, dtype)
            assert all(c["ok"] and c["finite"] for c in check.values()), \
                check
    q = torch.zeros(1, 2, 300, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_mha(q.half(), q.half(), q.half())


# head dims on the wide-head engine (csrc/flash_wide_sm90.cu): padded to
# multiples of 64 (136 -> 192 per RoPE quarter, 200 -> 256) and as built
# (192: one bf16 warpgroup of three boxes; 384 and 512: two warpgroups a
# CTA, f32 three and four boxes a lane slice)
WIDE_DIMS = [136, 192, 200, 256, 384, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("case", [
    "plain", "dense_bias", "kv_valid", "key_bias", "rope", "masked_rows",
    "strided"])
def test_flash_wide_kernels(dev, dtype, D, case):
    """The wide-head K4 (out and LSE) and K5 against their plain versions
    (chip_smoke.py's limits), on the wide launch counters only; rows
    without a live key write 0 with the LSE finfo.min and get no
    gradient."""
    g = torch.Generator(device=dev).manual_seed(D + 5)
    q, k, v, bias, kv_valid, rope = _flash_inputs(g, dev, dtype, case, D)
    kw = dict(bias=bias, kv_valid=kv_valid, rope=rope)
    n0, w0 = fa.flash_mha.launches, fa.flash_mha.launches_wide
    out, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
    assert (fa.flash_mha.launches, fa.flash_mha.launches_wide) == \
        (n0, w0 + 1)
    _close(out, lambda *a: fa.flash_mha_ref(*a, **kw), q, k, v)
    ref_lse = fa.flash_mha_ref(q, k, v, with_lse=True, **kw)[1]
    assert (lse - ref_lse).abs().max().item() \
        <= 1e-4 * (1 + ref_lse.abs().max().item())
    do = _rnd(g, dev, dtype, *q.shape)
    got = fa.flash_mha_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    plain = fa.flash_mha_bwd_ref(q, k, v, out, lse, do, **kw)
    exact = fa.flash_mha_bwd_ref(*_f32((q, k, v, out)), lse, _f32(do), **kw)
    check = chip_smoke._grad_check(got, plain, exact, dtype)
    assert all(c["ok"] and c["finite"] for c in check.values()), check
    if case == "masked_rows":
        assert (out[1] == 0).all() and (lse[1] == NEG).all()
        assert (got[0][1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 384])
def test_flash_wide_k5_repeats_bit_for_bit(dev, dtype, D):
    """The wide-head K5 adds in a fixed order (no atomics): two calls on
    the same inputs give the same bits, with RoPE tables and a dense
    bias, over several key and query tiles; at D = 384 the forward's
    output comes from two bf16 warpgroups (four f32 lane slices) and its
    LSE, which K5 reads, from the first."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, _, _, rope = _flash_inputs(g, dev, dtype, "rope", D, Nq=700,
                                        Nk=900)
    bias = torch.randn(2, 3, 700, 900, generator=g, device=dev)
    kw = dict(bias=bias, rope=rope)
    o, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
    do = _rnd(g, dev, dtype, *q.shape)
    first = fa.flash_mha_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_mha_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(o, fa.flash_mha(q, k, v, **kw))
    o2, lse2 = fa.flash_mha(q, k, v, with_lse=True, **kw)
    assert torch.equal(lse, lse2)
    # the forward's out and LSE feed K5 as the plain ones would
    plain = fa.flash_mha_bwd_ref(q, k, v, o, lse, do, **kw)
    exact = fa.flash_mha_bwd_ref(*_f32((q, k, v, o)), lse, _f32(do), **kw)
    check = chip_smoke._grad_check(first, plain, exact, dtype)
    assert all(c["ok"] and c["finite"] for c in check.values()), check


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 384, 512])
def test_wide_fully_masked_rows(dev, dtype, D):
    """K3 writes 0 for fully blocked rows, also across whole blocked key
    tiles it skips and for a row tile whose every key tile is skipped,
    and K4 for rows whose keys are all invalid; both against their plain
    versions (D = 384 and 512: two bf16 warpgroups, four f32 slices)."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = _rnd(g, dev, dtype, 2, 3, 200, D, s=QK_STD)
    k = _rnd(g, dev, dtype, 2, 3, 700, D, s=QK_STD)
    v = _rnd(g, dev, dtype, 2, 3, 700, D)
    blocked = torch.rand(2, 200, 700, generator=g, device=dev) > 0.1
    blocked[:, :, 64:448] = True                # whole blocked key tiles
    blocked[0, 5] = True
    blocked[1, 128:200] = True                  # whole row tiles
    out = ma.masked_mha(q, k, v, blocked)
    _close(out, ma.masked_mha_ref, q, k, v, blocked)
    assert (out[0, :, 5] == 0).all() and (out[1, :, 128:] == 0).all()
    valid = torch.ones(2, 700, dtype=torch.bool, device=dev)
    valid[1] = False
    o, lse = fa.flash_mha(q, k, v, kv_valid=valid, with_lse=True)
    _close(o, lambda *a: fa.flash_mha_ref(*a, kv_valid=valid), q, k, v)
    assert (o[1] == 0).all() and (lse[1] == NEG).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [576, 1088, 1600])
def test_wide_plan_cuts(dev, dtype, D):
    """Head dims past one CTA's lanes (``wide_plan``): bf16 576 three
    slices over two CTAs, the second with one warpgroup, 1088 five, 1600
    with Q streamed beside K (25 boxes: no room to keep it); f32 two, three
    and four CTAs along the lanes, a short or empty last slice.  K4 with
    its LSE and a key row, K3 with a mask, against the plain versions."""
    plan = fa.wide_plan(D, dtype)
    assert plan.groups > 1 and plan.recompute <= -(-D // 256)
    assert plan.qres == (dtype == torch.bfloat16 and D != 1600)
    g = torch.Generator(device=dev).manual_seed(D)
    q = _rnd(g, dev, dtype, 1, 2, 150, D, s=QK_STD)
    k = _rnd(g, dev, dtype, 1, 2, 333, D, s=QK_STD)
    v = _rnd(g, dev, dtype, 1, 2, 333, D)
    valid = torch.rand(1, 333, generator=g, device=dev) > 0.2
    out, lse = fa.flash_mha(q, k, v, kv_valid=valid, with_lse=True)
    _close(out, lambda *a: fa.flash_mha_ref(*a, kv_valid=valid), q, k, v)
    ref_lse = fa.flash_mha_ref(q, k, v, kv_valid=valid, with_lse=True)[1]
    assert (lse - ref_lse).abs().max().item() \
        <= 1e-4 * (1 + ref_lse.abs().max().item())
    blocked = torch.rand(1, 150, 333, generator=g, device=dev) > 0.3
    _close(ma.masked_mha(q, k, v, blocked), ma.masked_mha_ref, q, k, v,
           blocked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 384])
def test_wide_split_kv(dev, dtype, D):
    """Past ``WIDE_SPLIT_AFTER`` key tiles the wide forward walks runs of
    ``WIDE_SPLIT_TILES`` in CTAs of their own and merges them in order
    (``wide_merge``):
    K4 with tables, a key row and its LSE, and K3 with rows blocked in one
    run only, in every run (out 0) and with a whole run blocked for a row
    tile, against the plain versions; two calls give the same bits."""
    Nk = 2500
    assert fa.wide_plan(D, dtype, False, Nk).splits == 5
    g = torch.Generator(device=dev).manual_seed(D + 3)
    q, k, v, _, _, rope = _flash_inputs(g, dev, dtype, "rope", D, Nq=150,
                                        Nk=Nk)
    valid = torch.rand(2, Nk, generator=g, device=dev) > 0.2
    valid[1, :1100] = False                     # runs without live keys
    kw = dict(kv_valid=valid, rope=rope)
    out, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
    _close(out, lambda *a: fa.flash_mha_ref(*a, **kw), q, k, v)
    ref_lse = fa.flash_mha_ref(q, k, v, with_lse=True, **kw)[1]
    assert (lse - ref_lse).abs().max().item() \
        <= 1e-4 * (1 + ref_lse.abs().max().item())
    assert torch.equal(out, fa.flash_mha(q, k, v, **kw))
    blocked = torch.rand(2, 150, Nk, generator=g, device=dev) > 0.3
    blocked[0, :64, 1024:2048] = True           # runs, for a row tile
    blocked[0, 70] = True                       # every run
    blocked[1, 3, :2048] = True                 # live in the last run only
    got = ma.masked_mha(q, k, v, blocked)
    _close(got, ma.masked_mha_ref, q, k, v, blocked)
    assert (got[0, :, 70] == 0).all()
    assert torch.equal(got, ma.masked_mha(q, k, v, blocked))


def test_image_cast_matches_cpu_bit_for_bit(dev):
    """The uint8 normalization on the card equals the CPU's (and the JAX
    package's, tests/test_torch_ops.py) for every value."""
    img = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    for amp in (False, True):
        assert torch.equal(image_cast(img.to(dev), amp).cpu(),
                           image_cast(img, amp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", FLASH_DIMS)
@pytest.mark.parametrize("case", [
    "plain", "dense_bias", "head_shared_bias", "kv_valid", "key_bias",
    "bias_and_kv_valid", "rope", "masked_rows", "strided", "split_merge"])
def test_flash_bwd_kernel(dev, monkeypatch, dtype, D, case):
    """K5's dq, dk, dv against its plain version from K4's own output and
    LSE: f32 within 1e-4 of the plain gradient's max |value|; bf16 by the
    bf16 rule, per gradient.  ``split_merge``: the dkdv kernel (f32 and
    bf16) walks one query tile per split, so that 130 queries take three
    merged in order."""
    if case == "split_merge":
        monkeypatch.setattr(fa, "SPLIT_TILES", 1)
    g = torch.Generator(device=dev).manual_seed(D + 1)
    q, k, v, bias, kv_valid, rope = _flash_inputs(g, dev, dtype, case, D)
    do = _rnd(g, dev, dtype, *q.shape)
    kw = dict(bias=bias, kv_valid=kv_valid, rope=rope)
    o, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
    n0 = fa.flash_mha_bwd.launches
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, **kw)
    assert fa.flash_mha_bwd.launches == n0 + 2
    torch.cuda.synchronize()
    plain = fa.flash_mha_bwd_ref(q, k, v, o, lse, do, **kw)
    exact = fa.flash_mha_bwd_ref(*_f32((q, k, v, o)), lse, _f32(do), **kw)
    check = chip_smoke._grad_check(got, plain, exact, dtype)
    assert all(c["ok"] and c["finite"] for c in check.values()), check
    if case == "masked_rows":               # rows without a live key
        assert (got[0][1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("other", ["do", "o", "do_and_o"])
def test_flash_bwd_kernel_mixed_dtypes(dev, dtype, D, other):
    """K5 with ``do``, ``o`` or both in the other float type than q (f32
    on bf16 inputs, bf16 on f32 ones): Dvec takes them unrounded, as the
    plain version does, and the gradients pass the rule of
    test_flash_bwd_kernel against it."""
    g = torch.Generator(device=dev).manual_seed(D + 7)
    q, k, v, bias, kv_valid, rope = _flash_inputs(g, dev, dtype, "rope", D)
    kw = dict(bias=bias, kv_valid=kv_valid, rope=rope)
    alt = torch.bfloat16 if dtype == torch.float32 else torch.float32
    do = _rnd(g, dev, alt if other != "o" else dtype, *q.shape)
    o, lse = fa.flash_mha(q, k, v, with_lse=True, **kw)
    if other != "do":
        o = o.to(alt)
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    plain = fa.flash_mha_bwd_ref(q, k, v, o, lse, do, **kw)
    exact = fa.flash_mha_bwd_ref(*_f32((q, k, v, o)), lse, _f32(do), **kw)
    check = chip_smoke._grad_check(got, plain, exact, dtype)
    assert all(c["ok"] and c["finite"] for c in check.values()), check


@pytest.mark.parametrize("D", [64, 96])
def test_flash_f32_batch_and_query_invariant(dev, monkeypatch, D):
    """The f32 K4 and K5 on the 3xTF32 engine, with RoPE tables, dead key
    tiles, a batch without a live key and three dkdv splits: two calls
    give the same bits; the rows of batch b equal the slice of the full
    call bit for bit (K4's out and LSE, K5's dq, dk, dv); so do K4's out
    and LSE and K5's dq for query rows [a, a + n), though every slice runs
    another grid."""
    monkeypatch.setattr(fa, "SPLIT_TILES", 4)
    g = torch.Generator(device=dev).manual_seed(17 + D)
    dt = torch.float32
    B, H, Nq, Nk = 3, 2, 700, 333
    q = _rnd(g, dev, dt, B, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dt, B, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dt, B, H, Nk, D)
    do = _rnd(g, dev, dt, B, H, Nq, D)
    valid = torch.rand(B, Nk, generator=g, device=dev) > 0.2
    valid[0, 64:200] = False            # dead key tiles
    valid[2] = False                    # no live key: zeros, LSE finfo.min
    tabs = [rope2d_tables(torch.randint(0, 40, (B, n, 2), generator=g,
                                        device=dev), D) for n in (Nq, Nk)]

    def fwd(q, k, v, valid, qt, kt):
        return fa.flash_mha(q, k, v, kv_valid=valid, rope=(*qt, *kt),
                            with_lse=True)

    def bwd(q, k, v, o, lse, do, valid, qt, kt):
        return fa.flash_mha_bwd(q, k, v, o, lse, do, kv_valid=valid,
                                rope=(*qt, *kt))

    assert fa.dkv_splits(Nq) == 3
    out, lse = fwd(q, k, v, valid, *tabs)
    grads = bwd(q, k, v, out, lse, do, valid, *tabs)
    again = fwd(q, k, v, valid, *tabs) + bwd(q, k, v, out, lse, do, valid,
                                             *tabs)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, lse) + grads))
    assert (out[2] == 0).all() and (lse[2] == NEG).all()
    assert (grads[0][2] == 0).all()
    _close(out, lambda *a: fa.flash_mha_ref(*a[:3], kv_valid=a[3],
                                            rope=a[4]), q, k, v, valid,
           (*tabs[0], *tabs[1]))
    for b in range(B):
        sl = slice(b, b + 1)
        qt, kt = (tuple(t[sl] for t in tab) for tab in tabs)
        o_b, l_b = fwd(q[sl], k[sl], v[sl], valid[sl], qt, kt)
        assert torch.equal(o_b, out[sl]) and torch.equal(l_b, lse[sl]), b
        part = bwd(q[sl], k[sl], v[sl], out[sl], lse[sl], do[sl], valid[sl],
                   qt, kt)
        assert all(torch.equal(a, full[sl])
                   for a, full in zip(part, grads)), b
    for a, n in ((0, 100), (100, 600), (37, 1), (129, 300)):
        rows = slice(a, a + n)
        qt = tuple(t[:, rows].contiguous() for t in tabs[0])
        o_r, l_r = fwd(q[:, :, rows], k, v, valid, qt, tabs[1])
        assert torch.equal(o_r, out[:, :, rows]), (a, n)
        assert torch.equal(l_r, lse[:, :, rows]), (a, n)
        dq_r = bwd(q[:, :, rows], k, v, out[:, :, rows],
                   lse[:, :, rows].contiguous(), do[:, :, rows], valid, qt,
                   tabs[1])[0]
        assert torch.equal(dq_r, grads[0][:, :, rows]), (a, n)


# sha256 of ``_flash_bits``'s outputs as the f32 K4 and K5 of
# ``csrc/flash_{fwd,bwd}_sm90.cu`` computed them before the f32 K1 joined
# their pre-pass (split_planes' cls row), on an NVIDIA H100 80GB HBM3
# (sm_90a, nvcc 12.9, torch 2.11.0+cu128); the same bits after it
FLASH_F32_BITS = \
    "683ab720489332cc9daf70e52c1265c7aa43cebe13920f065547932e8bbed52b"


def _flash_bits(dev) -> str:
    """sha256 over the f32 K4's out and LSE and K5's dq, dk, dv (RoPE,
    key validity with dead tiles) and K4's out with a dense bias, D = 64
    and 96, on inputs drawn by numpy from fixed seeds."""
    import hashlib

    h = hashlib.sha256()
    for D in (64, 96):
        rng = np.random.default_rng(D)
        B, H, Nq, Nk = 2, 3, 130, 333

        def t(*shape, s=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * s)
                                    .astype(np.float32)).to(dev)

        q, k = t(B, H, Nq, D, s=QK_STD), t(B, H, Nk, D, s=QK_STD)
        v, do = t(B, H, Nk, D), t(B, H, Nq, D)
        valid = torch.from_numpy(rng.random((B, Nk)) > 0.2).to(dev)
        valid[0, 64:200] = False
        rope = (t(B, Nq, D), t(B, Nq, D), t(B, Nk, D), t(B, Nk, D))
        bias = t(B, H, Nq, Nk)
        out, lse = fa.flash_mha(q, k, v, kv_valid=valid, rope=rope,
                                with_lse=True)
        grads = fa.flash_mha_bwd(q, k, v, out, lse, do, kv_valid=valid,
                                 rope=rope)
        for x in (out, lse, *grads, fa.flash_mha(q, k, v, bias=bias)):
            h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def test_flash_f32_bits_unchanged(dev):
    """The f32 K4 and K5 give the bits they gave before the f32 K1 and K6
    came onto their engine (the pre-pass they share gained the cls row)."""
    assert _flash_bits(dev) == FLASH_F32_BITS


def test_k4_k5_route_by_dtype(dev, monkeypatch):
    """f32 K4 and K5 run the Hopper f32 engine's libraries, bf16 K4 and K5
    the bf16 Hopper engine's; one launch per K4 call and two per K5 call
    either way."""
    from panst3r_torch.ops import cuda_build

    names = []
    real = cuda_build.function

    def recording(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(cuda_build, "function", recording)
    g = torch.Generator(device=dev).manual_seed(6)
    for dtype, fwd, bwd in ((torch.float32, "flash_fwd_sm90",
                             "flash_bwd_sm90"),
                            (torch.bfloat16, "flash_fwd_bf16_sm90",
                             "flash_bwd_bf16_sm90")):
        q, k, v, *_ = _flash_inputs(g, dev, dtype, "plain", 96)
        n0, b0 = fa.flash_mha.launches, fa.flash_mha_bwd.launches
        del names[:]
        o, lse = fa.flash_mha(q, k, v, with_lse=True)
        assert names == [fwd], names
        fa.flash_mha_bwd(q, k, v, o, lse, q)
        torch.cuda.synchronize()
        assert names[1:] == [bwd] * 2, names
        assert fa.flash_mha.launches == n0 + 1
        assert fa.flash_mha_bwd.launches == b0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_through_kernels(dev, dtype):
    """K1-K3 gradients on the card bit-equal to their plain formula's on
    the same inputs, at small shapes (chip_smoke.py's ``phase_autograd``
    does it at the main paths'); K4 + K5 through autograd against
    autograd through ``flash_mha_ref`` (f32, within 1e-4 of the gradient's
    max); bf16, the Hopper K4 feeding the Hopper K5 its output and LSE,
    by the bf16 rule against the plain versions' chain
    (``flash_mha_ref``, then ``flash_mha_bwd_ref``) in bf16 and in f32."""
    g = torch.Generator(device=dev).manual_seed(11)
    qkv = _rnd(g, dev, dtype, 2, 300, 384, s=QK_STD).requires_grad_()
    tabs = rope2d_tables(torch.randint(0, 20, (2, 300, 2), generator=g,
                                       device=dev), 64)
    kc = _rnd(g, dev, dtype, 2, 1, 128, s=QK_STD).requires_grad_()
    vc = _rnd(g, dev, dtype, 2, 1, 128).requires_grad_()
    q, k, v = (_rnd(g, dev, dtype, 2, n, 128, s=s).requires_grad_()
               for n, s in ((300, QK_STD), (700, QK_STD), (700, 1.0)))
    kv_bias = torch.where(torch.rand(2, 700, generator=g, device=dev) < 0.3,
                          NEG, 0.0)
    mq, mk, mv = (_rnd(g, dev, dtype, 2, 8, n, 96, s=s).requires_grad_()
                  for n, s in ((100, QK_STD), (500, QK_STD), (500, 1.0)))
    blocked = torch.rand(2, 100, 500, generator=g, device=dev) > 0.3
    from panst3r_torch.ops.attention import dot_product_attention
    cases = (
        ((qkv,), lambda x: ta.tower_self_attention(x, 2, tabs),
         lambda x: ta.tower_self_attention_ref(x, 2, tabs)),
        ((qkv, kc, vc), lambda x, a, b: ta.tower_self_attention(
            x, 2, cls_kv=(a, b)),
         lambda x, a, b: ta.tower_self_attention_ref(x, 2, cls_kv=(a, b))),
        ((q, k, v), lambda a, b, c: ta.tower_cross_attention(
            a, b, c, kv_bias=kv_bias),
         lambda a, b, c: ta.tower_cross_attention_ref(a, b, c,
                                                      kv_bias=kv_bias)),
        ((mq, mk, mv), lambda a, b, c: ma.masked_mha(a, b, c, blocked),
         lambda a, b, c: dot_product_attention(a, b, c,
                                               mask=~blocked[:, None])),
    )
    for ins, fn, plain in cases:
        out = fn(*ins)
        cot = torch.randn(out.shape, generator=g, device=dev).to(dtype)
        got = torch.autograd.grad(out, ins, cot)
        want = torch.autograd.grad(plain(*ins), ins, cot)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    fq, fk, fv = (_rnd(g, dev, dtype, 2, 3, n, 96, s=s).requires_grad_()
                  for n, s in ((130, QK_STD), (333, QK_STD), (333, 1.0)))
    cot = torch.randn(2, 3, 130, 96, generator=g, device=dev).to(dtype)
    n0 = fa.flash_mha_bwd.launches
    got = torch.autograd.grad(fa.flash_mha(fq, fk, fv), (fq, fk, fv), cot)
    assert fa.flash_mha_bwd.launches == n0 + 2
    want = torch.autograd.grad(fa.flash_mha_ref(fq, fk, fv), (fq, fk, fv),
                               cot)
    if dtype == torch.float32:
        for a, b in zip(got, want):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    else:
        def chain(q, k, v, do):         # K4's and K5's plain versions
            o, lse = fa.flash_mha_ref(q, k, v, with_lse=True)
            return fa.flash_mha_bwd_ref(q, k, v, o, lse, do)

        ins = [t.detach() for t in (fq, fk, fv, cot)]
        check = chip_smoke._grad_check(got, chain(*ins),
                                       chain(*(t.float() for t in ins)),
                                       dtype)
        assert all(c["ok"] and c["finite"] for c in check.values()), check


def test_small_train_step_card_matches_cpu(dev):
    """A v2 train step at full width and depth 1 (V=2 at 64x96) on the card
    against the CPU: chip_smoke.py's ``small`` comparison (assignments,
    loss, gradients, frozen parameters)."""
    chip_smoke.phase_small_train(shape=(1, 2, 64, 96, 8), depth=1)


def _int8_inputs(g, dev, dtype, B, Nq, Nk, C, bias):
    q = _rnd(g, dev, dtype, B, Nq, C, s=QK_STD)
    k = _rnd(g, dev, dtype, B, Nk, C, s=QK_STD)
    v = _rnd(g, dev, dtype, B, Nk, C)
    if B == 2:
        k[1] *= 3                         # the k scale spans the batch
    qtab, ktab = (rope2d_tables(torch.randint(0, 32, (B, n, 2), generator=g,
                                              device=dev), 64)
                  for n in (Nq, Nk))
    kb = None
    if bias:
        kb = torch.zeros(B, Nk, device=dev)
        kb[:, 64:700] = NEG               # dead key tiles
        kb[:, 5:40] = -0.7                # a soft-biased span
        kb[:, -3:] = -float("inf")
    return q, k, v, qtab, ktab, kb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Nq,Nk,C,bias", [
    (1, 130, 333, 256, True), (1, 1, 64, 128, False),
    (1, 16384, 3000, 768, True),          # chip_smoke's gate_edge
    (2, 2000, 3072, 768, False),          # batch2
    (1, 300, 1000, 256, False)])          # Nk % 128 = 104 > 64: the last
                                          # tile's padding differs by tile
def test_tower_cross_int8_kernel(dev, dtype, B, Nq, Nk, C, bias):
    """K2-int8 against its plain version at the kernel's key tile (f32
    within 1e-4, bf16 by the bf16 rule against the plain version with f32
    v and p)."""
    g = torch.Generator(device=dev).manual_seed(Nq + Nk)
    args = _int8_inputs(g, dev, dtype, B, Nq, Nk, C, bias)
    n0 = ta.tower_cross_int8.launches
    out = ta.tower_cross_int8(*args)
    assert ta.tower_cross_int8.launches == n0 + 1
    tile = ta.BLOCK_K if dtype == torch.bfloat16 else ta.INT8_F32_TILE
    plain = functools.partial(ta.tower_cross_int8_ref, tile=tile)
    _close(out, lambda q, k, v, *rest: chip_smoke._by_rows(
        plain, q, rest[0], k, v, *rest[1:]), *args)


def test_int8_gate_launches(dev, monkeypatch):
    """With PANST3R_KV_INT8=1 the int8 kernel launches exactly where the
    JAX gate opens (tables and Nq >= 16384) and K2 elsewhere; on a shape
    the int8 kernel does not take it raises and launches nothing."""
    monkeypatch.setenv("PANST3R_KV_INT8", "1")
    g = torch.Generator(device=dev).manual_seed(3)
    for Nq, tables, want in ((16383, True, "k2"), (16384, True, "int8"),
                             (16384, False, "k2")):
        q, k, v, qtab, ktab, _ = _int8_inputs(g, dev, torch.bfloat16, 1, Nq,
                                              200, 128, False)
        if not tables:
            qtab = ktab = None
        n8 = ta.tower_cross_int8.launches
        n2 = ta.tower_cross_attention.launches
        ta.tower_cross_attention(q, k, v, qtab, ktab)
        assert (ta.tower_cross_int8.launches - n8,
                ta.tower_cross_attention.launches - n2) == \
            ((1, 0) if want == "int8" else (0, 1))
    q, k, v, qtab, ktab, _ = _int8_inputs(g, dev, torch.bfloat16, 1, 16384,
                                          200, 64, False)
    n8, n2 = ta.tower_cross_int8.launches, ta.tower_cross_attention.launches
    with pytest.raises(NotImplementedError, match="head pairs"):
        ta.tower_cross_attention(q, k, v, qtab, ktab)
    assert (ta.tower_cross_int8.launches,
            ta.tower_cross_attention.launches) == (n8, n2)


def test_small_serve_wires_card_match_cpu(dev):
    """The serve wires (every fusion_res, cameras, packed YUV input, the
    latency paths) of v1 at full width and depth 1 (V=5 at 64x96, f32) on
    the card against the CPU: seg_ids, labels and selected equal, pan on
    >= 99.9% of pixels, conf within 1/255 where pan agrees, cameras within
    1e-3 relative.  (The tiny preset's 32-wide heads run only on the CPU.)"""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model
    from panst3r_torch.ops.image import rgb_to_yuv420

    V, H, W = 5, 64, 96
    images, portrait, _ = chip_smoke._inputs(V, H, W)
    cfg = chip_smoke._config("v1", depth=1)
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device="cuda", seed=1)
    card.load_state_dict(cpu.state_dict())
    engs = {d: InferenceEngine(m, Bucket(H, W), num_keyframes=3, chunk=2,
                               amp=False, device=d)
            for d, m in (("cuda", card), ("cpu", cpu))}
    cls_emb = chip_smoke.segment_classes(engs["cpu"], images, portrait)
    calls = [("serve_device", images, dict(fusion_res=fr, with_cameras=True))
             for fr in ("full", "mask", "hybrid", "hybrid4")]
    calls += [("serve_device", rgb_to_yuv420(images), {}),
              ("serve_latency_device", images, dict(chunk=2)),
              ("serve_latency_overlap", images, dict(chunk=2))]
    for name, imgs, kw in calls:
        a, b = (e.unpack_wire(getattr(e, name)(imgs, portrait, cls_emb, **kw),
                              V, with_cameras=kw.get("with_cameras", False))
                for e in (engs["cuda"], engs["cpu"]))
        assert b["selected"].any()
        for k in ("seg_ids", "labels", "selected"):
            np.testing.assert_array_equal(a[k], b[k])
        same = a["pan"] == b["pan"]
        assert same.mean() >= 0.999, (name, kw, same.mean())
        assert np.abs(a["conf"] - b["conf"])[same].max() <= 1 / 255 + 1e-6
        for k in ("focals", "cam2world"):
            if k in a:
                assert np.abs(a[k] - b[k]).max() \
                    <= 1e-3 * np.abs(b[k]).max(), (name, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P,N,view", [
    (1, 1, 64, False), (2, 3, 768, True), (1, 8, 1536, False),
    (2, 4, 192, True), (3, 1, 64, True)])
def test_packed_flash_kernel(dev, dtype, B, P, N, view):
    """K6 on contiguous (B, P, N, 128) tensors and on the head-pair views
    of a (B, N, P·128) projection, one and several key tiles; N = 64 and
    192 leave half of the last 128-key tile of the bf16 kernel past N."""
    g = torch.Generator(device=dev).manual_seed(N + P)

    def make(s):
        if view:
            return _rnd(g, dev, dtype, B, N, P * 128, s=s) \
                .view(B, N, P, 128).transpose(1, 2)
        return _rnd(g, dev, dtype, B, P, N, 128, s=s)

    q, k, v = make(QK_STD), make(QK_STD), make(1.0)
    n0 = pa.packed_mha.launches
    out = pa.packed_mha(q, k, v)
    assert pa.packed_mha.launches == n0 + 1
    assert out.shape == (B, P, N, 128) and out.dtype == dtype
    _close(out, pa.packed_mha_ref, q, k, v)


def test_packed_flash_refuses(dev):
    """N not a multiple of the 64-row tiles, and a tensor that wants a
    gradient (K6 is forward-only), raise before any launch."""
    q = torch.zeros(1, 2, 100, 128, device=dev)
    with pytest.raises(NotImplementedError):
        pa.packed_mha(q, q, q)
    q = torch.zeros(1, 2, 64, 128, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        pa.packed_mha(q, q, q)


@pytest.mark.parametrize("preset", ["v1", "v2"])
def test_stage_flops_card_equal_cpu(dev, preset):
    """``stage_flops`` of the full-width model at depth 1 (V=3, K=2 at
    64x96): the kernels' declarations make the card's count the CPU's."""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    cfg = chip_smoke._config(preset, depth=1)
    counts = [InferenceEngine(build_model(cfg, device=d, seed=0),
                              Bucket(64, 96), num_keyframes=2, chunk=2,
                              amp=True, device=d).stage_flops(3, 2)
              for d in ("cuda", "cpu")]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_at_serve_many_batch(dev, dtype):
    """K2 and K3 at ``serve_many_device``'s batch of two scenes (a memory
    update, 768 queries against 3072 slots with 1536 valid plus the view's
    own 768 keys; the render, 6144 x 3072; the mask transformer, 8 heads
    of 96, 200 x 3072) against their plain versions, and each scene's rows
    bit-equal to the same call for that scene alone (the wire of one scene
    must not depend on the batch)."""
    g = torch.Generator(device=dev).manual_seed(17)
    C = 768
    valid = torch.ones(2, 3840, dtype=torch.bool, device=dev)
    valid[:, 1536:3072] = False
    for Nq, Nk, val in ((768, 3840, valid),
                        (6144, 3072, torch.ones(2, 3072, dtype=torch.bool,
                                                device=dev))):
        q = _rnd(g, dev, dtype, 2, Nq, C, s=QK_STD)
        k = _rnd(g, dev, dtype, 2, Nk, C, s=QK_STD)
        v = _rnd(g, dev, dtype, 2, Nk, C)
        qtab, ktab = (rope2d_tables(torch.randint(0, 32, (2, n, 2),
                                                  generator=g, device=dev),
                                    64) for n in (Nq, Nk))
        kb = torch.where(val, 0.0, NEG)
        out = ta.tower_cross_attention(q, k, v, qtab, ktab, kb)
        _close(out, ta.tower_cross_attention_ref, q, k, v, qtab, ktab, kb)
        for b in range(2):
            sl = slice(b, b + 1)
            part = ta.tower_cross_attention(
                q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous(),
                tuple(t[sl].contiguous() for t in qtab),
                tuple(t[sl].contiguous() for t in ktab), kb[sl].contiguous())
            assert torch.equal(part, out[sl]), (Nq, Nk, b)

    H, Nq, Nk, D = 8, 200, 3072, 96
    q = _rnd(g, dev, dtype, 2, H, Nq, D, s=QK_STD)
    k = _rnd(g, dev, dtype, 2, H, Nk, D, s=QK_STD)
    v = _rnd(g, dev, dtype, 2, H, Nk, D)
    blocked = torch.rand(2, Nq, Nk, generator=g, device=dev) > 0.05
    blocked[0, :, :1500] = True
    blocked[1, 100:] = True
    out = ma.masked_mha(q, k, v, blocked)
    _close(out, ma.masked_mha_ref, q, k, v, blocked)
    for b in range(2):
        sl = slice(b, b + 1)
        part = ma.masked_mha(q[sl].contiguous(), k[sl].contiguous(),
                             v[sl].contiguous(), blocked[sl].contiguous())
        assert torch.equal(part, out[sl]), b


def test_serve_many_card_matches_serve_device(dev):
    """``serve_many_device`` of two scenes of v1 at full width and depth 2
    (V=4 at 64x96, f32, hybrid wire with cameras) launches each kernel as
    often as one ``serve_device`` scene, and each scene's wire holds to
    that scene's ``serve_device`` wire by the small ``v1_serve`` rule (pan
    on >= 99.9% of pixels, seg_ids, labels and selected equal, cameras
    within 1e-3 relative)."""
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import InferenceEngine
    from panst3r_torch.models.panst3r import build_model

    V, K, H, W = 4, 3, 64, 96
    images, portrait, _ = chip_smoke._inputs(V, H, W)
    scenes = np.stack([images, np.roll(images, 1, axis=0)])
    cfg = chip_smoke._config("v1", depth=2)
    eng = InferenceEngine(build_model(cfg, device="cuda", seed=0),
                          Bucket(H, W), num_keyframes=K, chunk=2, amp=False,
                          device="cuda")
    cls_emb = chip_smoke.segment_classes(eng, images, portrait)
    ports = np.stack([portrait, portrait])
    kw = dict(fusion_res="hybrid", with_cameras=True)
    chip_smoke._reset_counts()
    wires = eng.serve_many_device(scenes, ports, cls_emb, **kw).cpu().numpy()
    many = chip_smoke._read_counts()
    segments = 0
    for s in range(2):
        chip_smoke._reset_counts()
        single = eng.serve_device(scenes[s], portrait, cls_emb, **kw)
        assert chip_smoke._read_counts() == many
        a, b = (eng.unpack_wire(w, V, with_cameras=True)
                for w in (wires[s], single.cpu().numpy()))
        for k in ("seg_ids", "labels", "selected"):
            np.testing.assert_array_equal(a[k], b[k])
        assert (a["pan"] == b["pan"]).mean() >= 0.999
        for k in ("focals", "cam2world"):
            assert np.abs(a[k] - b[k]).max() <= 1e-3 * np.abs(b[k]).max()
        segments += int(b["selected"].sum())
    assert segments > 0


def _small_checkpoint():
    """A complete v1-shaped reference state_dict at the verify tests'
    widths (encoder 32 x 2, decoder 24 x 2, DINO 32 x 2, tiny head) and
    its port."""
    import dataclasses

    from panst3r_torch.models.presets import tiny_config
    from panst3r_torch.port_checkpoint import port_checkpoint

    reference_state_dict = chip_smoke.reference_sd_module() \
        .reference_state_dict
    rep = dataclasses.replace
    cfg = tiny_config()
    cfg = rep(cfg, encoder=rep(cfg.encoder, embed_dim=32, num_heads=2),
              decoder=rep(cfg.decoder, enc_dim=32, dim=24, num_heads=2),
              dino=rep(cfg.dino, depth=2))
    sd = {k: v.numpy() for k, v in reference_state_dict(cfg, 5).items()}
    return sd, port_checkpoint(sd)[0]


def test_verify_card_parity_stage(dev):
    """verify_port's ``card_parity`` at the verify tests' widths: every
    stack card against CPU within chip_smoke's limits, the card's launches
    as the call structure implies (heads not of 64: K4 and K3 at padded
    head dims)."""
    from panst3r_torch.tools import verify_port as vp

    sd, ported = _small_checkpoint()
    out = vp.stage_card_parity(sd, ported, enc_heads=2, dec_heads=2)
    assert out["status"] == "ok", out
    assert len(out["modules"]) == 6 and all(m["ok"] for m in
                                            out["modules"].values())
    cfg = vp.config_from_state_dict(sd, enc_heads=2, dec_heads=2)
    assert out["launches"] == chip_smoke._ckpt_expected(cfg)
    assert out["launches"]["masked_attn"] == 2


def test_verify_forward_stage_launches(dev):
    """verify_port's ``forward`` stage on a full-width v1 reference
    state_dict: the v1 preset from ``load_ported_npz``, finite outputs,
    K1/K2/K3 launched as the call structure implies."""
    from panst3r_torch.models.presets import panst3r_v1_config
    from panst3r_torch.port_checkpoint import port_checkpoint
    from panst3r_torch.tools import verify_port as vp

    reference_state_dict = chip_smoke.reference_sd_module() \
        .reference_state_dict
    cfg = panst3r_v1_config()
    sd = {k: v.cpu().numpy()
          for k, v in reference_state_dict(cfg, 0, dev).items()}
    out = vp.stage_forward(sd, port_checkpoint(sd)[0], device=dev)
    assert out["status"] == "ok" and out["preset"] == "v1", out
    want = chip_smoke._ckpt_expected(cfg)
    assert out["launches"] == want
    assert min(want[k] for k in ("tower_self", "tower_cross",
                                 "masked_attn")) > 0
