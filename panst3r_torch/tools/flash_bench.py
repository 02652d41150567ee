"""The f32 K4 and K5 at LoftUp's shapes on the card, beside SDPA.

    python -m panst3r_torch.tools.flash_bench        # K4 B=4,10; K5 B=2,10
    python -m panst3r_torch.tools.flash_bench --fwd 4 --bwd 2 \
        --split-tiles 64,192

LoftUp's cross-attention: B views of 192x256 pixel queries against 24x32
patch tokens, 4 heads of 96 (B=4: a v2 scene's chunk; B=10: the train_v2
micro-step's B x V).  Random split-heads views of (B, N, H*D) projections
from seed 0, q and k at std 1.4 (logits with a std of about 2).  For each
case one JSON line: the kernel's ms (CUDA events over back-to-back calls,
warm L2), the device ms of each CUDA kernel of one traced call
(``core/profiling.py::profile_by_kernel``), its largest error against the
plain version run per slice of two views (K5: relative to each
gradient's max |value|), and one ``F.scaled_dot_product_attention`` call
on the same work (K5: its backward), a yardstick the port never calls.
K5 is timed with each fixed dkdv split of ``--split-tiles``.  It needs
the card.
"""
from __future__ import annotations

import argparse
import json

import torch


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _by_kernel(fn) -> dict:
    from panst3r_torch.core.profiling import profile_by_kernel

    prof = profile_by_kernel(fn, top=8)
    if not prof["top"]:                     # a trace that caught nothing
        prof = profile_by_kernel(fn, top=8)
    names = (t["name"].replace("(anonymous namespace)::", "")
             .replace("void ", "").split("(")[0].split("::")[-1]
             for t in prof["top"])
    return {n: t["ms"] for n, t in zip(names, prof["top"])}


def _sliced(fn, *ts, n: int = 2):
    parts = [fn(*(t[a:a + n] for t in ts)) for a in range(0, ts[0].shape[0],
                                                           n)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(x) for x in zip(*parts))
    return torch.cat(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fwd", default="4,10", help="K4 batches")
    ap.add_argument("--bwd", default="2,10", help="K5 batches")
    ap.add_argument("--split-tiles", default="64",
                    help="K5's dkdv splits to time (query tiles of 64)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench measures the card; there is no CUDA "
                         "device")
    import torch.nn.functional as F

    from panst3r_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    H, Nq, Nk, D = 4, 49152, 768, 96

    def heads(B, N, s=1.0):
        x = torch.randn(B, N, H * D, generator=g, device=dev) * s
        return x.view(B, N, H, D).transpose(1, 2)

    card = torch.cuda.get_device_name(0)
    for B in (int(x) for x in args.fwd.split(",") if x):
        q, k, v = heads(B, Nq, 1.4), heads(B, Nk, 1.4), heads(B, Nk)

        def fwd():
            return fa.flash_mha(q, k, v, with_lse=True)

        out, lse = fwd()
        torch.cuda.synchronize()
        ref, rlse = _sliced(lambda *t: fa.flash_mha_ref(*t, with_lse=True),
                            q, k, v)
        row = {"kernel": "flash_fwd", "batch": B, "card": card,
               "max_abs_err": float((out - ref).abs().max()),
               "lse_max_abs_err": float((lse - rlse).abs().max())}
        del ref, rlse, out, lse
        row.update(ms=_time_ms(fwd, args.reps),
                   device_ms_by_kernel=_by_kernel(fwd),
                   sdpa_ms=_time_ms(
                       lambda: F.scaled_dot_product_attention(q, k, v),
                       args.reps))
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    keep = fa.SPLIT_TILES
    for B in (int(x) for x in args.bwd.split(",") if x):
        q, k, v = heads(B, Nq, 1.4), heads(B, Nk, 1.4), heads(B, Nk)
        do = heads(B, Nq)
        o, lse = fa.flash_mha(q, k, v, with_lse=True)

        def bwd():
            return fa.flash_mha_bwd(q, k, v, o, lse, do)

        want = _sliced(fa.flash_mha_bwd_ref, q, k, v, o, lse, do)
        try:
            for st in (int(x) for x in args.split_tiles.split(",")):
                fa.SPLIT_TILES = st
                got = bwd()
                torch.cuda.synchronize()
                err = [float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(got, want)]
                del got
                print(json.dumps({
                    "kernel": "flash_bwd", "batch": B, "card": card,
                    "split_tiles": st, "max_rel_err": err,
                    "ms": _time_ms(bwd, args.reps),
                    "device_ms_by_kernel": _by_kernel(bwd)}), flush=True)
        finally:
            fa.SPLIT_TILES = keep
        del want
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ref = F.scaled_dot_product_attention(*ins)
        print(json.dumps({"kernel": "sdpa_backward", "batch": B,
                          "card": card, "ms": _time_ms(
                              lambda: torch.autograd.grad(
                                  ref, ins, do, retain_graph=True),
                              args.reps)}), flush=True)
        del q, k, v, do, o, lse, ins, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
