"""K6's plain version (the CPU path of ``packed_mha``) against the JAX
A/B tool's Pallas kernel ``tools/ab_attention_packed.py::packed_mha`` in
interpret mode, against the port's unpacked K4 formula, and the wrapper's
rules (``scale`` default, launch counter, the checks before a launch).

Limits: f32 1e-5 abs (a 1536-key softmax in f32; the Pallas kernel works
in the exp2 domain over two 768-key blocks, the plain version in natural
log over all keys at once).  bf16: against the f32 formula on the same
bf16 inputs, the plain version's max and RMS errors within 1.5x and 1.25x
the Pallas output's own (the rule the card holds the CUDA kernel to), and
within 2^-6 of the Pallas output (a few bf16 units of outputs of size ~1:
p is rounded to bf16 against the running max of two 128-key blocks in
Pallas and against the row max here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from panst3r_torch.ops import flash_attention as t_fa
from panst3r_torch.ops import packed_attention as pa
from tools import ab_attention_packed as j_ab
from tests.torch_release import release_memory  # noqa: F401


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal(shape) * 1.2 for _ in range(2))
    v = rng.standard_normal(shape)
    return [a.astype(np.float32) for a in (q, k, v)]


def _pallas(q, k, v, dtype, block):
    with pltpu.force_tpu_interpret_mode():
        out = j_ab.packed_mha(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                              block_q=block, block_k=block)
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def test_plain_matches_pallas_f32_two_key_blocks():
    q, k, v = _inputs((1, 2, 1536, 128), 0)
    want = _pallas(q, k, v, jnp.float32, 768)
    got = pa.packed_mha(*map(_torch, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_matches_pallas_bf16():
    q, k, v = _inputs((1, 2, 256, 128), 1)
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    exact = pa.packed_mha_ref(tq.float(), tk.float(), tv.float()).numpy()
    pallas = _pallas(q, k, v, jnp.bfloat16, 128)
    got = pa.packed_mha(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def stats(d):
        return np.abs(d).max(), np.sqrt(np.mean(d ** 2))

    gmax, grms = stats(got - exact)
    pmax, prms = stats(pallas - exact)
    assert gmax <= 1.5 * pmax and grms <= 1.25 * prms, (gmax, grms, pmax,
                                                        prms)
    assert np.abs(got - pallas).max() <= 2.0 ** -6


def test_packed_equals_unpacked_flash_formula():
    """Two heads per row through K6's formula equal the same heads split
    out and run through K4's plain version (f32)."""
    B, P, N = 2, 3, 192
    q, k, v = (_torch(a) for a in _inputs((B, P, N, 128), 2))

    def split(t):                 # (B, P, N, 128) -> (B, 2P, N, 64)
        return t.reshape(B, P, N, 2, 64).transpose(2, 3).reshape(
            B, 2 * P, N, 64)

    want = t_fa.flash_mha_ref(split(q), split(k), split(v))
    got = split(pa.packed_mha(q, k, v))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_scale_zero_means_default():
    q, k, v = (_torch(a) for a in _inputs((1, 1, 128, 128), 3))
    base = pa.packed_mha(q, k, v)
    for s in (0, 0.0, None, 64 ** -0.5):
        assert torch.equal(pa.packed_mha(q, k, v, s), base), s
    assert not torch.allclose(pa.packed_mha(q, k, v, 0.3), base)


def test_cpu_tensors_never_launch():
    q, k, v = (_torch(a) for a in _inputs((1, 2, 64, 128), 4))
    n0 = pa.packed_mha.launches
    pa.packed_mha(q, k, v)
    pa.packed_mha(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert pa.packed_mha.launches == n0


@pytest.mark.parametrize("case", ["ragged_n", "gradient", "lanes"])
def test_kernel_refuses_before_launch(case):
    """The checks that precede a launch, on meta tensors (no card here):
    N not a multiple of the 64-row tiles, a tensor that wants a gradient
    (K6 is forward-only, as the Pallas kernel is), a non-128-lane row."""
    shape = {"ragged_n": (1, 2, 100, 128), "lanes": (1, 2, 64, 64)}.get(
        case, (1, 2, 64, 128))
    q, k, v = (torch.empty(shape, device="meta") for _ in range(3))
    if case == "gradient":
        q.requires_grad_()
    err = ValueError if case == "lanes" else NotImplementedError
    with pytest.raises(err):
        pa._packed_kernel(q, k, v, 0.125)
