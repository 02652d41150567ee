"""The port's FLOP counter (``panst3r_torch/ops/flops.py``) against hand
counts (the cases of tests/test_flops.py), against the kernels' declared
work, and against the JAX package's counter
(``panst3r_tpu/ops/flops.py::fn_matmul_flops``): ``stage_flops`` per stage
at the tiny and tiny_v2 presets and at the v1 widths with every tower at
depth 1, and one tiny train step.  Counts are exact integers in f64, so
the limit of 1e-6 relative is far above any rounding.  Also the counter's
rules (no count without a declaration, no library attention, declarations
from any thread) and ``core/profiling.py`` on the CPU."""
import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panst3r_torch.core.bucketing import Bucket as TBucket
from panst3r_torch.core.profiling import PhaseTimer, trace
from panst3r_torch.engine.inference import InferenceEngine as TEngine
from panst3r_torch.models import presets as t_presets
from panst3r_torch.models.encoder import ViTEncoder
from panst3r_torch.models.panst3r import build_model
from panst3r_torch.ops import cuda_build, flops
from panst3r_torch.ops import flash_attention as fa
from panst3r_torch.ops import masked_attention as ma
from panst3r_torch.ops import packed_attention as pa
from panst3r_torch.ops import tower_attention as ta
from panst3r_torch.ops.flops import count_flops
from panst3r_tpu.core.bucketing import Bucket as JBucket
from panst3r_tpu.engine.fusion import _fusion_full as j_fusion_full
from panst3r_tpu.engine.inference import InferenceEngine as JEngine
from panst3r_tpu.models import memory as j_memlib
from panst3r_tpu.models import presets as j_presets
from panst3r_tpu.models.panst3r import PanSt3R as JPanSt3R
from panst3r_tpu.ops.flops import fn_matmul_flops

RTOL = 1e-6


# ------------------------------------------------------------ hand counts --

def test_plain_matmul():
    a, b = torch.zeros(7, 64, 32), torch.zeros(32, 96)
    assert count_flops(torch.matmul, a, b) == 2 * 7 * 64 * 32 * 96


def test_batched_matmul():
    a, b = torch.zeros(4, 10, 16), torch.zeros(4, 16, 20)
    got = count_flops(torch.einsum, "bij,bjk->bik", a, b)
    assert got == 2 * 4 * 10 * 16 * 20


def test_conv_and_its_backward():
    """A 3x3 'same' conv: 2·|out|·Cin·9; its backward adds the input
    gradient (the same work, stride 1) and the weight gradient (again)."""
    conv = torch.nn.Conv2d(8, 12, 3, padding=1)
    x = torch.zeros(1, 8, 16, 16, requires_grad=True)
    fwd = 2 * (1 * 12 * 16 * 16) * 8 * 9
    assert count_flops(conv, x) == fwd
    assert count_flops(lambda: conv(x).sum().backward()) == 3 * fwd


def test_vit_tower_matches_hand_count():
    """The v1 encoder tower at 64x96 (K1 declares its attention): the hand
    formula exactly."""
    H, W, V = 64, 96, 2
    cfg = t_presets.panst3r_v1_config().encoder
    with torch.device("meta"):
        enc = ViTEncoder(cfg)
    enc = enc.to_empty(device="cpu").to(torch.bfloat16)
    for p in enc.parameters():
        p.data.zero_()
    with torch.no_grad():
        got = count_flops(enc, torch.zeros(V, H, W, 3, dtype=torch.bfloat16))
    N, D, Fd, L = (H // 16) * (W // 16), 1024, 4096, 24
    per_layer = (2 * N * D * 3 * D      # qkv
                 + 2 * 2 * N * N * D    # qk^T + av
                 + 2 * N * D * D        # proj
                 + 2 * 2 * N * D * Fd)  # fc1 + fc2
    patch = 2 * N * (16 * 16 * 3) * D   # patch embed conv
    assert got == V * (L * per_layer + patch)


# ---------------------------------------------------------- declarations --

def _rnd(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kernel", ["K1", "K1_cls", "K2", "K2_int8", "K3",
                                    "K4", "K5", "K6"])
def test_wrapper_counts_its_declaration(kernel):
    """On the CPU each wrapper runs its plain version, whose aten ops are
    not counted: the count is the declared dense work, 4·B·H·Nq·Nk·D (K1
    with the cls column as one more key, K5 8·B·H·Nq·Nk·D)."""
    B, N, C, H = 2, 40, 128, 2

    def tabs(n):
        return torch.ones(B, n, 64), torch.zeros(B, n, 64)
    if kernel.startswith("K1"):
        cls = (_rnd(B, 1, C), _rnd(B, 1, C)) if kernel == "K1_cls" else None
        got = count_flops(ta.tower_self_attention, _rnd(B, N, 3 * C), H,
                          cls_kv=cls)
        want = 4 * B * H * N * (N + (cls is not None)) * 64
    elif kernel.startswith("K2"):
        fn = ta.tower_cross_int8 if kernel == "K2_int8" \
            else ta.tower_cross_attention
        got = count_flops(fn, _rnd(B, 30, C), _rnd(B, N, C), _rnd(B, N, C),
                          tabs(30), tabs(N))
        want = 4 * B * H * 30 * N * 64
    elif kernel == "K3":
        got = count_flops(ma.masked_mha, _rnd(B, 4, 30, 96),
                          _rnd(B, 4, N, 96), _rnd(B, 4, N, 96),
                          torch.zeros(B, 30, N, dtype=torch.bool))
        want = 4 * B * 4 * 30 * N * 96
    elif kernel == "K4":
        got = count_flops(fa.flash_mha, _rnd(B, 3, 30, 64), _rnd(B, 3, N, 64),
                          _rnd(B, 3, N, 64))
        want = 4 * B * 3 * 30 * N * 64
    elif kernel == "K5":
        q, k, v = _rnd(B, 3, 30, 64), _rnd(B, 3, N, 64), _rnd(B, 3, N, 64)
        o, lse = fa.flash_mha(q, k, v, with_lse=True)
        got = count_flops(fa.flash_mha_bwd, q, k, v, o, lse, _rnd(*o.shape))
        want = 8 * B * 3 * 30 * N * 64
    else:
        got = count_flops(pa.packed_mha, _rnd(B, 3, 64, 128),
                          _rnd(B, 3, 64, 128), _rnd(B, 3, 64, 128))
        want = 4 * B * 6 * 64 * 64 * 64
    assert got == want


def test_backward_counts_model_work_not_the_recompute():
    """K1's backward recomputes its plain forward (the JAX custom_vjp on a
    TPU); the count takes only the four products of the attention's
    backward, as the JAX package's CPU count (plain jnp) does."""
    B, N, C, H = 1, 32, 128, 2
    qkv = _rnd(B, N, 3 * C).requires_grad_()
    fwd = 4 * B * H * N * N * 64
    got = count_flops(lambda: ta.tower_self_attention(qkv, H).sum()
                      .backward())
    assert got == fwd + 2 * fwd


def test_launch_without_declaration_raises():
    """``cuda_build.check`` runs after every launch: under an open counter
    a launch outside any declaration raises instead of counting 0."""
    cuda_build.check(None, 0, "k")                 # no counter: fine
    with flops.FlopCounter():
        with flops.declare(1.0):
            cuda_build.check(None, 0, "k")
        with pytest.raises(RuntimeError, match="declaration"):
            cuda_build.check(None, 0, "k")


def test_library_attention_is_refused():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError, match="cannot attribute"):
        count_flops(F.scaled_dot_product_attention, q, q, q)


def test_declarations_from_another_thread_count():
    """The card runs autograd's backward (and K5's declaration) on its own
    thread: a declaration reaches the counter from any thread."""
    with flops.FlopCounter() as c:
        def declare():
            with flops.declare(5.0):
                pass

        th = threading.Thread(target=declare)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and c.total == 5.0


def test_peaks_known_card_only():
    pk = flops.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bfloat16"] == 989.4e12
    ms, by = flops.bound_ms(989.4e9, 1.0, "bfloat16",
                            card="NVIDIA H100 80GB HBM3")
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    with pytest.raises(KeyError):
        flops.peaks("NVIDIA A100-SXM4-40GB")


# ---------------------------------------------------- against JAX: stages --

# (preset, H, W, V, K, depth or None)
STAGE_CASES = {"tiny": ("tiny", 32, 48, 5, 3, None),
               "tiny_v2": ("tiny_v2", 32, 48, 5, 3, None),
               "v1_depth1": ("panst3r_v1", 64, 96, 3, 2, 1)}


def _depth(cfg, depth):
    if depth is None:
        return cfg
    rep = dataclasses.replace
    return rep(cfg, encoder=rep(cfg.encoder, depth=depth),
               dino=rep(cfg.dino, depth=depth),
               decoder=rep(cfg.decoder, depth=depth),
               panoptic=rep(cfg.panoptic, mask_transformer=rep(
                   cfg.panoptic.mask_transformer, dec_layers=depth)))


def jax_stage_flops(cfg, H, W, V, K, chunk=4):
    """The JAX engine's ``pipeline_flops`` by stage (the stages of
    tools/mfu_report.py::stage_flops) over ``jax.eval_shape``
    parameters, amp on."""
    model = JPanSt3R(cfg)
    mt = cfg.panoptic.mask_transformer
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, H, W, 3), jnp.bfloat16),
        jnp.zeros((1, 2), bool), jnp.zeros((32, mt.lang_dim), jnp.bfloat16),
        (H // 16, W // 16)))
    eng = JEngine.__new__(JEngine)
    eng.model, eng.params, eng.bucket = model, params, JBucket(H, W)
    eng.num_keyframes, eng.chunk, eng.amp = K, chunk, True
    eng.retrieval_head = None
    eng.__post_init__()
    S = jax.ShapeDtypeStruct
    N, dt = eng.n_tokens, jnp.bfloat16
    p = jax.tree_util.tree_map(lambda a: S(jnp.shape(a), a.dtype),
                               eng.params)
    mem = jax.tree_util.tree_map(
        lambda a: S(a.shape, a.dtype),
        j_memlib.init_memory(cfg.decoder.depth, 1, K * N, cfg.decoder.dim,
                             dtype=dt))
    img = S((V, H, W, 3), jnp.uint8)
    x = S((V, N, cfg.encoder.embed_dim), dt)
    pos = S((V, N, 2), jnp.int32)
    y = S((V, N, cfg.decoder.dim), dt)
    dino = S((V, N, cfg.dino.embed_dim), dt)
    cls = S((32, mt.lang_dim), dt)

    def one(a, n):
        return S((1, n) + a.shape[1:], a.dtype)

    def feats(n):
        return (one(x, n), one(y, n), one(dino, n)), \
            S((1, n, H, W, 3), jnp.uint8), one(pos, n), S((1, n), jnp.bool_)

    return {
        "encoder": fn_matmul_flops(
            functools.partial(eng._encode_batch, n=V), p, img),
        "dino": fn_matmul_flops(
            functools.partial(eng._dino_batch, n=V), p, img),
        "memory": fn_matmul_flops(
            functools.partial(eng._build_memory_jit,
                              schedule=tuple(cfg.mem_batches(K))),
            p, S((K,) + x.shape[1:], dt), mem, S((K, N, 2), jnp.int32)),
        "render": fn_matmul_flops(
            functools.partial(eng._render_batch, n=V), p, x, pos, mem),
        "pan_joint": fn_matmul_flops(eng._panoptic_joint, p, *feats(K), cls),
        "pan_queries": fn_matmul_flops(
            eng._panoptic_queries, p, *feats(V - K), cls,
            S((1, mt.num_queries, mt.hidden_dim), dt)),
        "fusion": fn_matmul_flops(
            lambda mc, mp: j_fusion_full(mc, mp, (H, W), "sigmoid", 0.1,
                                         None, 0.25, 0.5, 2, 0.1),
            S((1, mt.num_queries, 32), jnp.float32),
            S((1, V, mt.num_queries, H // 2, W // 2), jnp.float32)),
    }


def _port_engine(name, amp=True, seed=0):
    preset, H, W, V, K, depth = STAGE_CASES[name]
    cfg = _depth(getattr(t_presets, f"{preset}_config")(), depth)
    eng = TEngine(build_model(cfg, device="cpu", seed=seed), TBucket(H, W),
                  num_keyframes=K, chunk=4, amp=amp, device="cpu")
    return eng, (H, W, V, K)


@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_stage_flops_match_jax(name):
    preset, H, W, V, K, depth = STAGE_CASES[name]
    want = jax_stage_flops(
        _depth(getattr(j_presets, f"{preset}_config")(), depth), H, W, V, K)
    eng, _ = _port_engine(name)
    got = eng.stage_flops(V, K)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= RTOL * want[k], (k, got[k], want[k])
    assert eng.pipeline_flops(V, K) == sum(got.values())


def test_count_is_the_same_for_zero_and_random_images():
    """The staged pipeline counted as it runs, on zero and on random
    images, equals ``pipeline_flops`` (which runs the stages on zeros)."""
    eng, (H, W, V, K) = _port_engine("tiny", amp=False)
    rng = np.random.default_rng(0)
    cls_emb = rng.standard_normal((32, 24)).astype(np.float32)
    counts = []
    for images in (np.zeros((V, H, W, 3), np.uint8),
                   rng.integers(0, 256, (V, H, W, 3), dtype=np.uint8)):
        with flops.FlopCounter() as c:
            eng.fuse_device(eng.run_device(images, np.zeros(V, bool),
                                           cls_emb), (H, W))
        counts.append(c.total)
    assert counts[0] == counts[1] == eng.pipeline_flops(V, K)


# -------------------------------------------------- against JAX: training --

def test_train_step_flops_match_jax():
    """One tiny train step (forward, criterion and backward; the step of
    tests/test_torch_train.py) against the JAX counter over
    ``make_train_step``."""
    from panst3r_tpu.engine import criterion as j_crit
    from panst3r_tpu.engine import train as j_train
    from panst3r_torch.engine import criterion as t_crit
    from panst3r_torch.engine import train as t_train
    from tests.test_torch_criterion import jax_draws
    from tests.test_torch_train import GRID, LOSS, T, V, _jbatch, _models, _t

    jm, params, tm, batch, cls = _models("tiny", 2)
    jcfg = j_train.TrainConfig(lr=1e-3, accum_iter=1, epochs=2,
                               warmup_epochs=0,
                               loss=j_crit.PanopticLossConfig(**LOSS))
    tcfg = t_train.TrainConfig(lr=1e-3, accum_iter=1, epochs=2,
                               warmup_epochs=0,
                               loss=t_crit.PanopticLossConfig(**LOSS))
    key = jax.random.PRNGKey(4)
    tmask = j_train.trainable_mask(params)
    tx, _ = j_train.build_optimizer(jcfg, 1, 4, trainable_mask=tmask)
    jstep = j_train.make_train_step(jm, tx, jcfg.loss, GRID, donate=False,
                                    train_mask=tmask)
    want = fn_matmul_flops(jstep, j_train.TrainState.create(params, tx),
                           _jbatch(batch), jnp.asarray(cls), key)

    mask = t_train.trainable_mask(tm)
    opt = t_train.Optimizer({n: p for n, p in tm.named_parameters()
                             if mask[n]}, tcfg, 1, 4)
    step = t_train.make_train_step(tm, opt, tcfg.loss, GRID)
    levels = tm.config.panoptic.mask_transformer.dec_layers + 1
    got = count_flops(step, t_train.batch_to(batch, "cpu"), _t(cls),
                      draws=jax_draws(key, tcfg.loss, levels, 2 * T * V))
    assert abs(got - want) <= RTOL * want, (got, want)


# ------------------------------------------------------------- profiling --

def test_phase_timer_and_trace_on_cpu(tmp_path):
    timer = PhaseTimer()
    x = torch.ones(64, 64)
    for _ in range(2):
        with timer.phase("matmul", x):
            x = torch.tanh(x @ x)
    s = timer.summary()["matmul"]
    assert s["count"] == 2 and s["total_s"] > 0
    assert "matmul" in timer.report()
    with trace(str(tmp_path)):
        torch.relu(x @ x)
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
