"""A/B of the attention variants at the encoder tower's shape (the port of
tools/ab_attention_packed.py:114-215).

    python -m panst3r_torch.tools.ab_attention_packed            # the card
    python -m panst3r_torch.tools.ab_attention_packed --device cpu --layers 2

Shape: B=8 views, H=16 heads, N=768 tokens, D=64, bf16, ``--layers`` (24)
layers in a Python loop whose output is the next layer's q (the JAX tool's
``lax.scan``).  Inputs are numpy draws from seed 0 in the projection
layout (B, N, H·D): q and k at std 0.3, v at std 1; RoPE tables of a
24×32 patch grid, base 100.  Variants (the JAX tool's names without their
``pallas-`` / ``xla-`` prefixes):

- ``unpacked``: K4 ``flash_mha`` on the split-heads views;
- ``packed``: K6 ``packed_mha`` on the head-pair views;
- ``native``: the plain ``ops/attention.py::dot_product_attention``;
- ``rope-tabs``: K4 with the RoPE tables;
- ``tower-plain``, ``tower-rope``: K1 on the concatenated qkv (the
  concatenation is a copy the model does not make: an upper bound);
- ``sdpa``: ``F.scaled_dot_product_attention``, a yardstick no path of the
  port calls.

K4 and K6 read the (B, N, H·D) layout in place through strides and write
the merged layout, so here no variant but ``native`` and ``sdpa`` pays a
relayout.  Printed, one JSON line each: the packed-vs-unpacked max abs
error (the tool's parity check), each variant's ms per layer (CUDA events;
on the CPU the host clock, as ``cpu_ms_per_layer``), and the card's bound
per layer (``ops/flops.py``).  The JAX tool's "50% lane cap" roofline is a
TPU fact and is not carried over.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

B, H, N, D = 8, 16, 768, 64
GRID = (24, 32)


def inputs(device, dtype=torch.bfloat16):
    """(x, kx, vx) in the projection layout and the RoPE tables."""
    from panst3r_torch.ops.rope import patch_grid_positions, rope2d_tables

    rng = np.random.default_rng(0)
    x, kx, vx = (torch.as_tensor(rng.standard_normal((B, N, H * D)) * s)
                 .to(device=device, dtype=dtype) for s in (0.3, 0.3, 1.0))
    pos = patch_grid_positions(*GRID, device)[None].expand(B, N, 2)
    return x, kx, vx, rope2d_tables(pos, D, 100.0)


def split_heads(t):            # (B, N, H·D) -> (B, H, N, D) view
    return t.view(B, N, H, D).transpose(1, 2)


def split_pairs(t):            # (B, N, H·D) -> (B, H/2, N, 128) view
    return t.view(B, N, H // 2, 2 * D).transpose(1, 2)


def merge(t):                  # (B, h, N, d) -> (B, N, h·d)
    return t.transpose(1, 2).reshape(B, N, H * D)


def variants(kx, vx, tabs) -> dict:
    """name -> one layer c (B, N, H·D) -> (B, N, H·D)."""
    import torch.nn.functional as F

    from panst3r_torch.ops.attention import dot_product_attention
    from panst3r_torch.ops.flash_attention import flash_mha
    from panst3r_torch.ops.packed_attention import packed_mha
    from panst3r_torch.ops.tower_attention import tower_self_attention

    kh, vh = split_heads(kx), split_heads(vx)
    kp, vp = split_pairs(kx), split_pairs(vx)
    return {
        "unpacked": lambda c: merge(flash_mha(split_heads(c), kh, vh)),
        "packed": lambda c: merge(packed_mha(split_pairs(c), kp, vp)),
        "native": lambda c: merge(dot_product_attention(split_heads(c), kh,
                                                        vh)),
        "rope-tabs": lambda c: merge(flash_mha(split_heads(c), kh, vh,
                                               rope=(*tabs, *tabs))),
        "tower-plain": lambda c: tower_self_attention(
            torch.cat([c, kx, vx], -1), H),
        "tower-rope": lambda c: tower_self_attention(
            torch.cat([c, kx, vx], -1), H, tabs=tabs),
        "sdpa": lambda c: merge(F.scaled_dot_product_attention(
            split_heads(c), kh, vh)),
    }


def run_layers(layer, x, layers: int):
    c = x
    for _ in range(layers):
        c = layer(c)
    return c


def parity(x, kx, vx) -> float:
    """Max abs difference of K6 and K4 on one layer (both in bf16)."""
    from panst3r_torch.ops.flash_attention import flash_mha
    from panst3r_torch.ops.packed_attention import packed_mha

    a = merge(flash_mha(split_heads(x), split_heads(kx), split_heads(vx)))
    b = merge(packed_mha(split_pairs(x), split_pairs(kx), split_pairs(vx)))
    return float((a.float() - b.float()).abs().max())


def time_layers(layer, x, layers: int, reps: int) -> float:
    """ms per layer: CUDA events around ``reps`` runs of ``layers`` layers
    after a warm-up run (the host clock on the CPU)."""
    run_layers(layer, x, layers)
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run_layers(layer, x, layers)
        return (time.perf_counter() - t0) * 1e3 / (reps * layers)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run_layers(layer, x, layers)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * layers)


def bound_per_layer() -> tuple[float, str]:
    """The card's least time for one layer: 4·B·H·N²·D FLOPs in bf16
    against q, k, v read once and the output written once."""
    from panst3r_torch.ops import flops

    return flops.bound_ms(flops.attention_flops(B, H, N, N, D),
                          4 * B * N * H * D * 2, "bfloat16")


def run(device="cuda", layers: int = 24, reps: int = 5) -> dict:
    """Every variant at the tool's shape on ``device``: {parity error,
    ms per layer by variant, bound}."""
    from panst3r_torch.core.device import resolve_device

    dev = resolve_device(device)
    x, kx, vx, tabs = inputs(dev)
    on_card = dev.type == "cuda"
    res = {"shape": [B, H, N, D], "dtype": "bfloat16", "layers": layers,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "packed_vs_unpacked_max_abs_err": parity(x, kx, vx)}
    key = "ms_per_layer" if on_card else "cpu_ms_per_layer"
    with torch.inference_mode():
        res[key] = {name: time_layers(fn, x, layers, reps)
                    for name, fn in variants(kx, vx, tabs).items()}
    if on_card:
        res["bound_ms_per_layer"], res["bound_by"] = bound_per_layer()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(args.device, args.layers, args.reps)
    print(json.dumps({"packed_vs_unpacked_max_abs_err":
                      res["packed_vs_unpacked_max_abs_err"]}))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
