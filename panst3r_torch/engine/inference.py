"""Inference engine: keyframe memory build + joint panoptic prediction +
per-frame decode of the other views (counterpart of
panst3r_tpu/engine/inference.py, the staged ``run_device`` / ``run`` /
``fuse`` path).

Pipeline:
  1. encode all views (encoder and DINO in chunks of ``chunk`` views);
  2. linspace keyframes, keyframes first; memory over the keyframes on the
     [2, 1, 1, ...] schedule;
  3. render all views against the frozen memory (``chunk`` views per
     decoder call, as one (1, chunk·N) query set);
  4. joint mask-transformer decode over the keyframes; the other views go
     through the prediction heads with the frozen keyframe queries;
  5. masks back to input order.

``amp`` casts the floating parameters to bf16 and normalizes uint8 images
in bf16 (as the JAX engine does).  ``run_fused``, the serving paths,
``MultiBucketEngine`` and retrieval keyframes wait for later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from panst3r_torch.core.bucketing import Bucket
from panst3r_torch.core.device import resolve_device
from panst3r_torch.models import memory as memlib
from panst3r_torch.models.decoder import postprocess
from panst3r_torch.models.panst3r import PanSt3R
from panst3r_torch.ops.image import image_cast


def select_keyframes_linspace(n_views: int, num_keyframes) -> list[int]:
    """Uniform keyframe selection (panst3r_tpu/engine/retrieval.py:242)."""
    if num_keyframes is None or num_keyframes >= n_views:
        return list(range(n_views))
    return np.linspace(0, n_views - 1, num_keyframes, dtype=int).tolist()


@dataclasses.dataclass
class InferenceEngine:
    model: PanSt3R
    bucket: Bucket
    num_keyframes: int = 16
    chunk: int = 4
    amp: bool = True
    device: Optional[object] = None

    def __post_init__(self):
        c = self.model.config
        self.device = resolve_device(self.device)
        self.grid = self.bucket.grid(c.encoder.patch_size)
        self.n_tokens = self.grid[0] * self.grid[1]
        self.dtype = torch.bfloat16 if self.amp else torch.float32
        self.model = self.model.to(self.device)
        if self.amp:
            self.model = self.model.to(torch.bfloat16)
        self.model.eval()

    def _tick(self, times, name, t0):
        if times is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        if name is not None:
            times[name] = times.get(name, 0.0) + (t - t0)
        return t

    def _chunks(self, V: int):
        step = min(self.chunk, V)
        return [(s, min(step, V - s)) for s in range(0, V, step)]

    def encode_batch(self, images):
        """images (V, H, W, 3) on the device → x (V, N, C), pos (V, N, 2)."""
        xs, poss = [], []
        for s, n in self._chunks(images.shape[0]):
            img = image_cast(images[s:s + n], self.amp)
            x, pos = self.model.encode(img[None])
            xs.append(x[0])
            poss.append(pos[0])
        return torch.cat(xs), torch.cat(poss)

    def dino_batch(self, images):
        outs = []
        for s, n in self._chunks(images.shape[0]):
            img = image_cast(images[s:s + n], self.amp)
            outs.append(self.model.encode_dino(img[None])[0])
        return torch.cat(outs)

    def build_memory(self, x_kf, pos_kf):
        """Incremental memory over keyframes: [init, +1, +1, ...]."""
        c = self.model.config
        K = x_kf.shape[0]
        mem = memlib.init_memory(c.decoder.depth, 1, K * self.n_tokens,
                                 c.decoder.dim, dtype=self.dtype,
                                 device=self.device)
        start = 0
        for nb in c.mem_batches(K):
            mem = self.model.decoder_update(x_kf[None, start:start + nb],
                                            pos_kf[None, start:start + nb],
                                            mem, self.grid)[0]
            start += nb
        return mem

    def render_batch(self, x, pos, mem):
        """Render all views against the frozen memory, ``chunk`` per call."""
        pms, ys = [], []
        for s, n in self._chunks(x.shape[0]):
            pm, y = self.model.decoder_render(x[None, s:s + n],
                                              pos[None, s:s + n], mem,
                                              self.grid)
            pms.append(pm[0])
            ys.append(y[0])
        return torch.cat(pms), torch.cat(ys)

    @torch.inference_mode()
    def run_device(self, images, portrait, cls_embeddings,
                   num_keyframes: Optional[int] = None,
                   stage_times: Optional[dict] = None) -> dict:
        """Device-resident pipeline.  images (V, H, W, 3) uint8 or float
        ([-1, 1]); portrait (V,) bool; cls_embeddings (ncls, lang_dim).
        Returns device tensors {pointmaps_raw (V, H, W, 7), pred_logits
        (Q, ncls), pred_masks (V, Q, Hm, Wm), out_queries, keyframes}.
        ``stage_times``: a dict to receive per-stage seconds (the device is
        synchronized at each stage boundary only when it is given)."""
        dev = self.device
        V = images.shape[0]
        K = min(num_keyframes or self.num_keyframes, V)
        t = self._tick(stage_times, None, 0.0)
        images = torch.as_tensor(images, device=dev)
        portrait = torch.as_tensor(portrait, device=dev)
        cls_emb = torch.as_tensor(cls_embeddings, device=dev).to(self.dtype)
        t = self._tick(stage_times, "upload", t)

        x, pos = self.encode_batch(images)
        t = self._tick(stage_times, "encoder", t)
        keyframes = select_keyframes_linspace(V, K)
        not_keyframes = sorted(set(range(V)) - set(keyframes))
        kf = torch.as_tensor(keyframes, device=dev)
        mem = self.build_memory(x[kf], pos[kf])
        t = self._tick(stage_times, "memory", t)
        pm_all, y_all = self.render_batch(x, pos, mem)
        t = self._tick(stage_times, "render", t)
        dino_all = self.dino_batch(images)
        t = self._tick(stage_times, "dino", t)

        panout_kf = self.model.panoptic(
            (x[kf][None], y_all[kf][None], dino_all[kf][None]),
            portrait[kf][None], cls_emb, self.grid, deep_supervision=False)
        masks = [panout_kf["pred_masks"][0]]
        if not_keyframes:
            nk = torch.as_tensor(not_keyframes, device=dev)
            panout_nk = self.model.panoptic(
                (x[nk][None], y_all[nk][None], dino_all[nk][None]),
                portrait[nk][None], cls_emb, self.grid,
                memory_queries=panout_kf["out_queries"])
            masks.append(panout_nk["pred_masks"][0])
        inv = torch.as_tensor(np.argsort(keyframes + not_keyframes),
                              device=dev)
        masks = torch.cat(masks)[inv]
        self._tick(stage_times, "panoptic", t)
        return {
            "pointmaps_raw": pm_all,
            "pred_logits": panout_kf["pred_logits"][0],
            "pred_masks": masks,
            "out_queries": panout_kf["out_queries"][0],
            "keyframes": list(keyframes),
        }

    def run(self, images, portrait, cls_embeddings,
            num_keyframes: Optional[int] = None) -> dict:
        """run_device + postprocess, returned as host numpy arrays (f32)."""
        out = self.run_device(images, portrait, cls_embeddings, num_keyframes)
        post = postprocess(out["pointmaps_raw"].float())

        def host(t):
            return t.float().cpu().numpy()

        return {
            "pointmaps": {k: host(v) for k, v in post.items()},
            "pointmaps_raw": host(out["pointmaps_raw"]),
            "pred_logits": host(out["pred_logits"]),
            "pred_masks": host(out["pred_masks"]),
            "out_queries": host(out["out_queries"]),
            "keyframes": out["keyframes"],
        }

    def fuse(self, out_device: dict, true_shape: tuple[int, int],
             **fusion_kw) -> list[dict]:
        """Panoptic fusion of a run_device output on the device; only the
        final (V, H, W) maps come back to the host."""
        from panst3r_torch.engine.fusion import panoptic_fusion

        with torch.inference_mode():
            return panoptic_fusion(
                torch.as_tensor(out_device["pred_logits"])[None].float(),
                torch.as_tensor(out_device["pred_masks"])[None].float(),
                true_shape, **fusion_kw)
