"""Where the bf16 K4 -> K5 gradient error comes from, on the card.

    python -m panst3r_torch.tools.k5_bf16_witness [--seeds 16]
    python -m panst3r_torch.tools.k5_bf16_witness --device cpu --seeds 4

The bf16 gradients of ``flash_mha`` are K5 (``flash_mha_bwd``) fed K4's
output and LSE.  This tool computes them four ways on the same inputs:
out and LSE from K4's kernel or from its plain version ``flash_mha_ref``,
then the gradients from K5's kernel or from its plain version
``flash_mha_bwd_ref``.  Each is held, by ``chip_smoke.bf16_check``'s bf16
rule (max error within 1.5x and RMS within 1.25x of the bf16 reference's
own error against its f32 run), to two references:

- ``autograd``: autograd through ``flash_mha_ref`` in bf16 and in f32;
- ``chain``: ``flash_mha_ref`` then ``flash_mha_bwd_ref``, in bf16 and f32.

A source that reads over the rule with ``flash_mha_ref``'s out and LSE
fed to K5's kernel puts the excess in K5; one that reads over it only
with K4's kernel output puts it in K4, and the two mixed sources (the
kernel's out with the plain LSE, and the reverse) say which of the two
carries it.  The ``forward`` line holds K4's output by the bf16 rule
and gives how far its out, LSE and Dvec = rowsum(do * out) are from the
plain version's.  The inputs are
``tests/test_torch_cuda.py::test_gradients_through_kernels``'s (its
generator's draws replayed: 2 x 3 heads, 130 queries x 333 keys, D = 96)
and ``--seeds`` more draws of the same shapes.  One JSON line per input
and gradient source: each gradient's max error over its limit
(``max_over_limit``; above 1 fails) and RMS over its limit.  With
``--device cpu`` the wrappers run their plain versions (so the four
sources read alike: how the plain pair itself fares against autograd) on
the seeded draws only, since the test's inputs are the card generator's.
"""
from __future__ import annotations

import argparse
import json

import torch


def _rnd(g, dev, dtype, *shape, s=1.0):
    return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)


def test_inputs(dev, dtype=torch.bfloat16):
    """The K4/K5 inputs of ``test_gradients_through_kernels``: its
    generator (seed 11) replayed through every draw made before them (the
    scales leave the generator's state alone, so they are left out)."""
    g = torch.Generator(device=dev).manual_seed(11)
    _rnd(g, dev, dtype, 2, 300, 384)                      # qkv
    torch.randint(0, 20, (2, 300, 2), generator=g, device=dev)
    _rnd(g, dev, dtype, 2, 1, 128)                        # kc
    _rnd(g, dev, dtype, 2, 1, 128)                        # vc
    for n in (300, 700, 700):                             # q, k, v
        _rnd(g, dev, dtype, 2, n, 128)
    torch.rand(2, 700, generator=g, device=dev)           # kv_bias
    for n in (100, 500, 500):                             # mq, mk, mv
        _rnd(g, dev, dtype, 2, 8, n, 96)
    torch.rand(2, 100, 500, generator=g, device=dev)      # blocked
    for shape in ((2, 300, 128), (2, 300, 128), (2, 300, 128),
                  (2, 8, 100, 96)):                       # K1-K3 cotangents
        torch.randn(shape, generator=g, device=dev)
    return _draw(g, dev, dtype)


def _draw(g, dev, dtype):
    from chip_smoke import QK_STD

    q, k, v = (_rnd(g, dev, dtype, 2, 3, n, 96, s=s)
               for n, s in ((130, QK_STD), (333, QK_STD), (333, 1.0)))
    do = torch.randn(2, 3, 130, 96, generator=g, device=dev).to(dtype)
    return q, k, v, do


def witness(q, k, v, do) -> dict:
    """Every gradient source held to both references by the bf16 rule."""
    import chip_smoke
    from panst3r_torch.ops import flash_attention as fa

    def autograd(*ts):
        ins = [t.detach().clone().requires_grad_() for t in ts[:3]]
        return torch.autograd.grad(fa.flash_mha_ref(*ins), ins, ts[3])

    def chain(*ts):
        o, lse = fa.flash_mha_ref(*ts[:3], with_lse=True)
        return fa.flash_mha_bwd_ref(*ts[:3], o, lse, ts[3])

    f32 = [t.float() for t in (q, k, v, do)]
    refs = {"autograd": (autograd(q, k, v, do), autograd(*f32)),
            "chain": (chain(q, k, v, do), chain(*f32))}
    with torch.no_grad():
        fwd = {"k4_kernel": fa.flash_mha(q, k, v, with_lse=True),
               "k4_plain": fa.flash_mha_ref(q, k, v, with_lse=True)}
    (ok, lk), (op, lp) = fwd["k4_kernel"], fwd["k4_plain"]
    # the kernel's output with the plain LSE and the reverse: which of the
    # two carries a difference into the gradients
    fwd["k4_kernel_out+plain_lse"] = (ok, lp)
    fwd["plain_out+k4_kernel_lse"] = (op, lk)
    bwd = {"k5_kernel": fa.flash_mha_bwd, "k5_plain": fa.flash_mha_bwd_ref}
    out = {}
    for fname, (o, lse) in fwd.items():
        for bname, fn in bwd.items():
            got = fn(q, k, v, o, lse, do)
            row = {}
            for rname, (plain, exact) in refs.items():
                check = chip_smoke._grad_check(got, plain, exact,
                                               torch.bfloat16)
                row[rname] = {
                    n: {"max_over_limit": c["kernel_max"] / c["limit_max"],
                        "rms_over_limit": c["kernel_rms"] / c["limit_rms"],
                        "kernel_max": c["kernel_max"],
                        "limit_max": c["limit_max"], "ok": c["ok"]}
                    for n, c in check.items()}
            out[f"{fname}->{bname}"] = row
    o32, l32 = fa.flash_mha_ref(*f32[:3], with_lse=True)
    dvec = {n: (do.float() * o.float()).sum(-1)
            for n, o in (("kernel", ok), ("plain", op), ("f32", o32))}
    out["forward"] = {
        "out": chip_smoke.bf16_check(ok.float(), op.float(), o32),
        "out_elements_differing": int((ok != op).sum()),
        "out_max_abs_diff": float((ok.float() - op.float()).abs().max()),
        "lse_max_abs_diff": float((lk - lp).abs().max()),
        "dvec_kernel_err_max": float((dvec["kernel"] - dvec["f32"]).abs()
                                     .max()),
        "dvec_plain_err_max": float((dvec["plain"] - dvec["f32"]).abs()
                                    .max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=16,
                    help="draws of the same shapes beyond the test's")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    inputs = [] if dev.type == "cpu" \
        else [("test_gradients_through_kernels", test_inputs(dev))]
    for s in range(args.seeds):
        g = torch.Generator(device=dev).manual_seed(s)
        inputs.append((f"seed{s}", _draw(g, dev, torch.bfloat16)))
    for label, ts in inputs:
        for source, row in witness(*ts).items():
            print(json.dumps({"inputs": label, "source": source, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
