"""Inference engine: keyframe memory build + joint panoptic prediction +
per-frame decode of the other views (counterpart of
panst3r_tpu/engine/inference.py, the staged ``run_device`` / ``run`` /
``fuse`` path).

Pipeline:
  1. encode all views (encoder and DINO in chunks of ``chunk`` views);
  2. linspace keyframes, keyframes first (or retrieval: pooled cosine, or
     the trained ``retrieval_head`` with ASMK); memory over the keyframes
     on the [2, 1, 1, ...] schedule, rebuilt ``refine_iterations`` times
     with the decoder's feedback of the keyframes rendered against the
     previous memory (``build_memory``);
  3. render all views against the frozen memory (``chunk`` views per
     decoder call, as one (1, chunk·N) query set);
  4. the panoptic head on the keyframes (joint mask-transformer decode),
     then on the other views (prediction heads with the frozen keyframe
     queries): two calls, as in the JAX engine.  The v2 head's mixer and
     LoftUp run in each call, and LoftUp's min-max scaling spans the views
     of its call;
  5. masks back to input order.

``amp`` casts the floating parameters to bf16 and normalizes uint8 images
in bf16 (as the JAX engine does).

The serving wire path (the JAX engine's one-program serving, here eager
calls with the same shapes): ``run_fused`` runs the encoder and DINO on
all V views in one batch and renders ALL V views in ONE decoder call
(``Nq = V·N``, which opens K2-int8's gate at render-scale V), then the
keyframe and non-keyframe head calls; ``serve_device`` adds the on-device
fusion, 8-bit quantization, optional cameras (``engine/pose.py``) and
retrieval keyframes, and packs one uint8/uint16 wire buffer that
``unpack_wire`` decodes on the host.  ``serve_latency_device`` and
``serve_latency_overlap`` upload in chunks (packed YUV420 decoded per
chunk) and run the towers per chunk; ``serve_stream`` pipelines scenes
with a fetcher thread; ``serve_many_device`` runs S scenes as one batch
(the JAX engine's ``vmap``): the towers once over S·V views, and the
memory build, the render and each head call at batch S, so each kernel
launches as often as for one scene; one wire per scene.  Every input may
be packed YUV420 (``ops/image.py``).  ``stage_flops`` / ``pipeline_flops``
count a scene's matmul work for MFU (``ops/flops.py``).

Over a mesh (``core/mesh.py``): a tensor-parallel model
(``core/tp.py::apply_tp``) serves as it is; ``run_device`` and
``serve_device`` take the mesh's ``mem`` group (``mem_group``): the
memory bank is built split over it, each rank holding its slice of the
capacity, and the decoder gathers the slices before K2
(``models/memory.py``); ``serve_many_device`` takes its ``data`` group
(``data_group``), runs this rank's share of the scenes and all-gathers the
wires.

``MultiBucketEngine`` runs a scene whose views lie in different resolution
buckets (mixed aspect ratios): one ``InferenceEngine`` per bucket over one
shared model, one token memory shared by every bucket's keyframes (tokens
of different grids side by side, each with its own 2-D position), and one
joint panoptic decode whose masked cross-attention spans every bucket's
keyframe tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue as _queue
import threading
from typing import Optional

import numpy as np
import torch

from panst3r_torch.core.bucketing import Bucket
from panst3r_torch.core.device import resolve_device, tick
from panst3r_torch.core.mesh import all_gather_cat, local_slice
from panst3r_torch.models import memory as memlib
from panst3r_torch.models.decoder import postprocess
from panst3r_torch.models.panst3r import PanSt3R
from panst3r_torch.engine.retrieval import (
    select_keyframes_linspace, select_keyframes_retrieval,
    select_keyframes_retrieval_device)
from panst3r_torch.ops.image import image_cast, is_packed_yuv, yuv420_decode

_FUSION_RES = ("full", "mask", "hybrid", "hybrid4")


@dataclasses.dataclass
class InferenceEngine:
    model: PanSt3R
    bucket: Bucket
    num_keyframes: int = 16
    chunk: int = 4
    amp: bool = True
    device: Optional[object] = None
    # the trained retrieval head (``engine/retrieval.py::RetrievalHead``)
    # for ``run_device(use_retrieval=True)``; None: pooled cosine
    retrieval_head: object = None
    # the mesh's mem axis of the call in flight (``_mem_sharded``)
    _mem_group = None

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
        return tick(times, name, t0, self.device)

    @contextlib.contextmanager
    def _mem_sharded(self, group):
        """``build_memory`` splits the banks over the ``mem`` group for one
        call."""
        self._mem_group = group
        try:
            yield
        finally:
            self._mem_group = None

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

    def build_memory(self, x_kf, pos_kf, refine_iterations: int = 0):
        """Incremental memory over keyframes: [init, +1, +1, ...].  x_kf
        (K, N, C) and pos_kf (K, N, 2), or (S, K, …) for S scenes in one
        batch (a memory of batch S).  Each of ``refine_iterations`` passes
        renders the keyframes against the previous memory (``chunk`` views
        a call) and builds a fresh memory whose updates feed those
        features back (``PanSt3R.decoder_update_feedback``); the first
        build has no feedback."""
        c = self.model.config
        if x_kf.dim() == 3:
            x_kf, pos_kf = x_kf[None], pos_kf[None]
        S, K = x_kf.shape[:2]

        def one_build(feedback):
            mem = memlib.init_memory(c.decoder.depth, S, K * self.n_tokens,
                                     c.decoder.dim, dtype=self.dtype,
                                     device=self.device,
                                     group=self._mem_group)
            start = 0
            for nb in c.mem_batches(K):
                part = slice(start, start + nb)
                if feedback is None:
                    mem = self.model.decoder_update(
                        x_kf[:, part], pos_kf[:, part], mem, self.grid)[0]
                else:
                    mem = self.model.decoder_update_feedback(
                        x_kf[:, part], pos_kf[:, part], mem, self.grid,
                        feedback[:, part])[0]
                start += nb
            return mem

        mem = one_build(None)
        for _ in range(refine_iterations):
            mem = one_build(self.render_batch(x_kf, pos_kf, mem)[1])
        return mem

    def render_batch(self, x, pos, mem):
        """Render all views against the frozen memory, ``chunk`` per call:
        x (V, N, C), or (S, V, N, C) against a memory of batch S."""
        batched = x.dim() == 4
        if not batched:
            x, pos = x[None], pos[None]
        pms, ys = [], []
        for s, n in self._chunks(x.shape[1]):
            pm, y = self.model.decoder_render(x[:, s:s + n],
                                              pos[:, s:s + n], mem,
                                              self.grid)
            pms.append(pm)
            ys.append(y)
        pm, y = torch.cat(pms, 1), torch.cat(ys, 1)
        return (pm, y) if batched else (pm[0], y[0])

    def run_device(self, images, portrait, cls_embeddings,
                   num_keyframes: Optional[int] = None,
                   stage_times: Optional[dict] = None,
                   use_retrieval: bool = False, mem_group=None) -> dict:
        """``_run_device`` (below); ``mem_group``: the mesh's mem axis, over
        which the memory bank is split (``models/memory.py``)."""
        with self._mem_sharded(mem_group):
            return self._run_device(images, portrait, cls_embeddings,
                                    num_keyframes, stage_times,
                                    use_retrieval)

    @torch.inference_mode()
    def _run_device(self, images, portrait, cls_embeddings,
                    num_keyframes: Optional[int] = None,
                    stage_times: Optional[dict] = None,
                    use_retrieval: bool = False) -> dict:
        """Device-resident pipeline.  images (V, H, W, 3) uint8 or float
        ([-1, 1]); portrait (V,) bool; cls_embeddings (ncls, lang_dim).
        Returns device tensors {pointmaps_raw (V, H, W, 7), pred_logits
        (Q, ncls), pred_masks (V, Q, Hm, Wm), out_queries, keyframes}.
        ``stage_times``: a dict to receive per-stage seconds (the device is
        synchronized at each stage boundary only when it is given).
        ``use_retrieval``: keyframes by retrieval on the host instead of
        linspace (ASMK through ``retrieval_head`` when it has a codebook,
        else the pooled cosine)."""
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
        if use_retrieval and V > K:
            keyframes = select_keyframes_retrieval(
                x.float(), K, head=self.retrieval_head)
        else:
            keyframes = select_keyframes_linspace(V, K)
        not_keyframes = sorted(set(range(V)) - set(keyframes))
        kf = torch.as_tensor(keyframes, device=dev)
        mem = self.build_memory(x[kf], pos[kf])
        t = self._tick(stage_times, "memory", t)
        pm_all, y_all = self.render_batch(x, pos, mem)
        t = self._tick(stage_times, "render", t)
        dino_all = self.dino_batch(images)
        t = self._tick(stage_times, "dino", t)

        nk = torch.as_tensor(not_keyframes, dtype=torch.int64, device=dev)
        out = self._heads(image_cast(images, self.amp)[None], x[None],
                          y_all[None], dino_all[None], pos[None],
                          portrait[None], cls_emb, kf[None], nk[None])
        self._tick(stage_times, "panoptic", t)
        return {"pointmaps_raw": pm_all, **{k: v[0] for k, v in out.items()},
                "keyframes": list(keyframes)}

    def _heads(self, img, x, y, dino, pos, portrait, cls_emb, kf, nk) -> dict:
        """The keyframe head call (joint mask-transformer decode), then the
        other views' call with the frozen keyframe queries (two calls, as
        in the JAX engine); masks back to input order.  Every tensor has a
        leading scene axis, and each call runs all S scenes as one batch:
        ``img`` the cast images (S, V, H, W, 3); ``kf`` / ``nk`` index
        tensors (S, K) and (S, V − K)."""
        def head(idx, queries=None):
            return self.model.panoptic(
                (_pick(x, idx), _pick(y, idx), _pick(dino, idx)),
                _pick(img, idx), _pick(pos, idx), _pick(portrait, idx),
                cls_emb, self.grid, memory_queries=queries,
                deep_supervision=False if queries is None else None,
                per_scene=True)

        panout_kf = head(kf)
        masks = [panout_kf["pred_masks"]]
        if nk.shape[-1]:
            masks.append(head(nk, panout_kf["out_queries"])["pred_masks"])
        inv = torch.argsort(torch.cat([kf, nk], -1), dim=-1)
        return {"pred_logits": panout_kf["pred_logits"],
                "pred_masks": _pick(torch.cat(masks, 1), inv),
                "out_queries": panout_kf["out_queries"]}

    def run(self, images, portrait, cls_embeddings,
            num_keyframes: Optional[int] = None,
            use_retrieval: bool = False) -> dict:
        """run_device + postprocess, returned as host numpy arrays (f32)."""
        out = self.run_device(images, portrait, cls_embeddings, num_keyframes,
                              use_retrieval=use_retrieval)
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

    def fuse_device(self, out_device: dict, true_shape: tuple[int, int],
                    label_mode: str = "sigmoid", niters: int = 2):
        """Fusion kept on the device: (pan (1, V, H, W) int32, conf,
        seg_ids, labels, selected) as device tensors."""
        from panst3r_torch.engine.fusion import _fusion_full

        with torch.inference_mode():
            return _fusion_full(
                torch.as_tensor(out_device["pred_logits"])[None].float(),
                torch.as_tensor(out_device["pred_masks"])[None].float(),
                tuple(true_shape), label_mode, 0.1, None, 0.25, 0.5, niters,
                0.1)

    # ---- serving wire path: one upload, one wire download per scene ----

    def _upload(self, x):
        """A host array (or tensor) on the engine's device; host memory is
        pinned first so that the copy is asynchronous on the card."""
        t = torch.as_tensor(x)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _scene_args(self, portrait, cls_embeddings):
        return (self._upload(portrait),
                self._upload(cls_embeddings).to(self.dtype))

    def _towers(self, images):
        """Raw images (uint8, float or packed YUV420) on the device → cast
        images and the encoder and DINO tokens of all of them in one
        batch each."""
        img = image_cast(images, self.amp)
        x, pos = self.model.encode(img[None])
        dino = self.model.encode_dino(img[None])
        return img, x[0], pos[0], dino[0]

    def _pipeline_tail(self, img, x, pos, dino, portrait, cls_emb, K: int,
                       keyframe_mode: str = "linspace") -> dict:
        """After the towers, for S scenes at once (every tensor with a
        leading scene axis, (S, V, …)): keyframes → memory (batch S) → ONE
        render of all views (batch S) → the keyframe head call → the
        non-keyframe call with the frozen queries; masks back to input
        order.  The outputs keep the scene axis."""
        S, V = x.shape[:2]
        dev = x.device
        if keyframe_mode == "retrieval":
            kf = torch.stack([select_keyframes_retrieval_device(x[s], K)
                              for s in range(S)])
            is_kf = torch.zeros(S, V, dtype=torch.int32, device=dev) \
                .scatter_(1, kf, 1)
            nk = torch.argsort(is_kf, dim=-1, stable=True)[:, :V - K]
        elif keyframe_mode == "linspace":
            keyframes = select_keyframes_linspace(V, K)
            kf = torch.as_tensor(keyframes, device=dev).expand(S, K)
            nk = torch.as_tensor(sorted(set(range(V)) - set(keyframes)),
                                 dtype=torch.int64, device=dev) \
                .expand(S, V - K)
        else:
            raise ValueError(f"keyframe_mode {keyframe_mode!r}")
        mem = self.build_memory(_pick(x, kf), _pick(pos, kf))
        pm, y = self.model.decoder_render(x, pos, mem, self.grid)
        return {"pointmaps_raw": pm,              # already input order
                **self._heads(img, x, y, dino, pos, portrait, cls_emb, kf,
                              nk),
                "keyframes_dev": kf}

    def _tail_one(self, img, x, pos, dino, portrait, cls_emb, K: int,
                  keyframe_mode: str = "linspace") -> dict:
        """``_pipeline_tail`` of one scene (no scene axis in or out)."""
        out = self._pipeline_tail(img[None], x[None], pos[None], dino[None],
                                  portrait[None], cls_emb, K, keyframe_mode)
        return {k: v[0] for k, v in out.items()}

    def _fused(self, images, portrait, cls_emb, K: int,
               keyframe_mode: str = "linspace") -> dict:
        img, x, pos, dino = self._towers(images)
        return self._tail_one(img, x, pos, dino, portrait, cls_emb, K,
                              keyframe_mode)

    @torch.inference_mode()
    def run_fused(self, images, portrait, cls_embeddings,
                  num_keyframes: Optional[int] = None) -> dict:
        """The one-program pipeline's order of work (linspace keyframes):
        device tensors like ``run_device`` plus ``keyframes``."""
        V = images.shape[0]
        K = min(num_keyframes or self.num_keyframes, V)
        portrait, cls_emb = self._scene_args(portrait, cls_embeddings)
        out = self._fused(self._upload(images), portrait, cls_emb, K)
        out["keyframes"] = select_keyframes_linspace(V, K)
        return out

    def _pack_wire(self, out: dict, cls_emb, V: int, label_mode: str,
                   niters: int, fusion_res: str, with_cameras: bool,
                   keyframe_mode: str) -> torch.Tensor:
        """Fusion + 8-bit quantization + wire packing of a pipeline output:
        [pan | conf | seg_ids | labels | selected | keyframes? | cameras?]
        as one uint8 wire (uint16 when an id may not fit a byte).
        ``fusion_res``: "full" fuses at (H, W); "mask" at the mask
        resolution (pan and conf at half size); "hybrid" / "hybrid4" fuse
        at (H, W) and ship conf 2×2 / 4×4 mean-pooled."""
        from panst3r_torch.engine.fusion import _fusion_full

        if fusion_res not in _FUSION_RES:
            raise ValueError(f"fusion_res {fusion_res!r} not in {_FUSION_RES}")
        H, W = self.bucket.shape
        Q = self.model.config.panoptic.mask_transformer.num_queries
        ncls = cls_emb.shape[0]
        kf_max = V if keyframe_mode == "retrieval" else 0
        wdtype = (torch.uint8 if Q < 255 and ncls < 255 and kf_max <= 255
                  else torch.uint16)
        fh, fw = (tuple(out["pred_masks"].shape[-2:])
                  if fusion_res == "mask" else (H, W))
        pan, conf, seg_ids, labels, selected = _fusion_full(
            out["pred_logits"][None].float(), out["pred_masks"][None].float(),
            (fh, fw), label_mode, 0.1, None, 0.25, 0.5, niters, 0.1)
        conf_hw = conf[0]
        if fusion_res.startswith("hybrid"):
            s = int(fusion_res[6:] or 2)
            if fh % s or fw % s:
                raise ValueError(f"fusion_res={fusion_res!r}: fusion grid "
                                 f"{fh}x{fw} not divisible by {s}")
            conf_hw = conf_hw.reshape(V, fh // s, s, fw // s, s) \
                .mean(dim=(2, 4))
        conf_q = torch.clamp(conf_hw * 255.0, 0, 255)
        # parts are made in int32 and cast once: the card's torch may lack
        # kernels for the unsigned 16-bit type beyond a copy
        parts = [pan[0].reshape(-1).to(torch.int32),
                 conf_q.reshape(-1).to(torch.int32),
                 seg_ids[0].to(torch.int32), labels[0].to(torch.int32),
                 selected[0].to(torch.int32)]
        if keyframe_mode == "retrieval":
            parts.append(out["keyframes_dev"].to(torch.int32))
        if with_cameras:
            from panst3r_torch.engine.pose import recover_cameras
            from panst3r_torch.models.decoder import postprocess

            post = postprocess(out["pointmaps_raw"].float())
            focals, c2w = recover_cameras(post, (H, W))
            cam = torch.cat([focals.reshape(-1), c2w.reshape(-1)]).float()
            parts.append(cam.view(torch.uint8).to(torch.int32))
        return torch.cat(parts).to(wdtype)

    @torch.inference_mode()
    def serve_device(self, images, portrait, cls_embeddings,
                     num_keyframes: Optional[int] = None,
                     label_mode: str = "sigmoid", niters: int = 2,
                     fusion_res: str = "full", with_cameras: bool = False,
                     keyframe_mode: str = "linspace",
                     mem_group=None) -> torch.Tensor:
        """Whole scene → packed wire (a device tensor); fetch it with
        ``fetch_wire`` and decode with ``unpack_wire``.  ``images``
        (V, H, W, 3) uint8 or packed YUV420 (V, H·3/2, W); ``portrait`` and
        ``cls_embeddings`` may be staged on the device once by the caller.
        ``with_cameras`` appends the recovered focals and cam2world poses
        as f32 bytes; ``keyframe_mode="retrieval"`` selects keyframes on
        the device and ships them.  ``mem_group``: the mesh's mem axis,
        over which the memory bank is split."""
        V = images.shape[0]
        K = min(num_keyframes or self.num_keyframes, V)
        portrait, cls_emb = self._scene_args(portrait, cls_embeddings)
        with self._mem_sharded(mem_group):
            out = self._fused(self._upload(images), portrait, cls_emb, K,
                              keyframe_mode)
        return self._pack_wire(out, cls_emb, V, label_mode, niters,
                               fusion_res, with_cameras, keyframe_mode)

    def _tower_chunks(self, images, order, chunk: int, on_chunk=None):
        """Upload ``images[order]`` in chunks, each decoded on the device
        when packed YUV420 and run through the towers as it lands.
        ``on_chunk(n_done)`` runs after each chunk.  Returns the uint8/float
        chunks and the token lists."""
        packed = is_packed_yuv(images)
        imgs, xs, poss, dinos = [], [], [], []
        done = 0
        for s in range(0, len(order), chunk):
            idx = order[s:s + chunk]
            img = self._upload(images[idx] if torch.is_tensor(images)
                               else np.asarray(images)[idx])
            if packed:
                img = yuv420_decode(img)
            _, x, pos, dino = self._towers(img)
            imgs.append(img)
            xs.append(x)
            poss.append(pos)
            dinos.append(dino)
            done += len(idx)
            if on_chunk is not None:
                on_chunk(done, imgs, xs, poss, dinos)
        return imgs, xs, poss, dinos

    @torch.inference_mode()
    def serve_latency_device(self, images, portrait, cls_embeddings,
                             num_keyframes: Optional[int] = None,
                             label_mode: str = "sigmoid", niters: int = 2,
                             fusion_res: str = "full",
                             with_cameras: bool = False,
                             keyframe_mode: str = "linspace",
                             chunk: Optional[int] = None) -> torch.Tensor:
        """Single-scene latency path: chunked uploads, each chunk's towers
        launched as it lands, then one tail (memory → render → heads →
        fusion → wire).  The same wire as ``serve_device``."""
        V = images.shape[0]
        K = min(num_keyframes or self.num_keyframes, V)
        chunk = min(chunk or self.chunk, V)
        portrait, cls_emb = self._scene_args(portrait, cls_embeddings)
        imgs, xs, poss, dinos = self._tower_chunks(images, list(range(V)),
                                                   chunk)
        img = image_cast(torch.cat(imgs), self.amp)
        out = self._tail_one(img, torch.cat(xs), torch.cat(poss),
                             torch.cat(dinos), portrait, cls_emb, K,
                             keyframe_mode)
        return self._pack_wire(out, cls_emb, V, label_mode, niters,
                               fusion_res, with_cameras, keyframe_mode)

    @torch.inference_mode()
    def serve_latency_overlap(self, images, portrait, cls_embeddings,
                              num_keyframes: Optional[int] = None,
                              label_mode: str = "sigmoid", niters: int = 2,
                              fusion_res: str = "full",
                              with_cameras: bool = False,
                              chunk: Optional[int] = None) -> torch.Tensor:
        """Keyframes-first chunked uploads: once the K keyframes are
        encoded, the memory build, the keyframe render (``render_batch``,
        ``chunk`` views per call) and the keyframe head call are issued
        while later chunks still upload; the last step renders the V − K
        other views in one call, runs their head call with the frozen
        queries, and packs the wire.  The same wire as ``serve_device``
        (linspace keyframes only)."""
        V = images.shape[0]
        K = min(num_keyframes or self.num_keyframes, V)
        chunk = min(chunk or self.chunk, V)
        keyframes = select_keyframes_linspace(V, K)
        nk_list = sorted(set(range(V)) - set(keyframes))
        if not nk_list:
            return self.serve_latency_device(
                images, portrait, cls_embeddings, num_keyframes=K,
                label_mode=label_mode, niters=niters, fusion_res=fusion_res,
                with_cameras=with_cameras, chunk=chunk)
        order = list(keyframes) + nk_list
        portrait, cls_emb = self._scene_args(portrait, cls_embeddings)
        port_ord = portrait[torch.as_tensor(order, device=self.device)]
        mid = {}

        def launch_mid(done, imgs, xs, poss, dinos):
            if mid or done < K:
                return
            x, pos = torch.cat(xs)[:K], torch.cat(poss)[:K]
            img = image_cast(torch.cat(imgs)[:K], self.amp)
            mem = self.build_memory(x, pos)
            pm_kf, y_kf = self.render_batch(x, pos, mem)
            mid.update(mem=mem, pm_kf=pm_kf, panout=self.model.panoptic(
                (x[None], y_kf[None], torch.cat(dinos)[:K][None]), img[None],
                pos[None], port_ord[:K][None], cls_emb, self.grid,
                deep_supervision=False))

        imgs, xs, poss, dinos = self._tower_chunks(images, order, chunk,
                                                   launch_mid)
        x, pos = torch.cat(xs)[K:], torch.cat(poss)[K:]
        img = image_cast(torch.cat(imgs)[K:], self.amp)
        pm_nk, y_nk = self.model.decoder_render(x[None], pos[None],
                                                mid["mem"], self.grid)
        panout = mid["panout"]
        panout_nk = self.model.panoptic(
            (x[None], y_nk, torch.cat(dinos)[K:][None]), img[None], pos[None],
            port_ord[K:][None], cls_emb, self.grid,
            memory_queries=panout["out_queries"])
        inv = torch.as_tensor(np.argsort(order), device=self.device)
        out = {"pred_logits": panout["pred_logits"][0],
               "pred_masks": torch.cat([panout["pred_masks"][0],
                                        panout_nk["pred_masks"][0]])[inv]}
        if with_cameras:
            out["pointmaps_raw"] = torch.cat([mid["pm_kf"], pm_nk[0]])[inv]
        return self._pack_wire(out, cls_emb, V, label_mode, niters,
                               fusion_res, with_cameras, "linspace")

    @torch.inference_mode()
    def serve_many_device(self, scenes, portrait, cls_embeddings,
                          num_keyframes: Optional[int] = None,
                          label_mode: str = "sigmoid", niters: int = 2,
                          fusion_res: str = "full",
                          with_cameras: bool = False,
                          data_group=None) -> torch.Tensor:
        """S scenes as one batch: ``scenes`` (S, V, H, W, 3) uint8 or
        packed YUV420 (S, V, H·3/2, W), ``portrait`` (S, V); linspace
        keyframes shared by every scene.  The towers run once over all S·V
        views; the memory build, the render and each head call run at
        batch S (the stages a single scene leaves at batch 1), so each
        kernel launches as often as for one scene.  Fusion and packing run
        per scene.  Returns the (S, L) device wires, row s equal to
        ``serve_device`` of scene s.  ``data_group``: the mesh's data axis;
        each rank runs its S/n scenes (``local_slice``) and the wires are
        all-gathered, so every rank returns all S."""
        scenes = local_slice(torch.as_tensor(scenes), 0, data_group)
        portrait = local_slice(torch.as_tensor(portrait), 0, data_group)
        S, V = scenes.shape[:2]
        K = min(num_keyframes or self.num_keyframes, V)
        portrait, cls_emb = self._scene_args(portrait, cls_embeddings)
        images = self._upload(scenes)
        towers = self._towers(images.reshape(S * V, *images.shape[2:]))
        out = self._pipeline_tail(
            *(t.reshape(S, V, *t.shape[1:]) for t in towers),
            portrait.reshape(S, V), cls_emb, K)
        return all_gather_cat(torch.stack([
            self._pack_wire({k: v[s] for k, v in out.items()}, cls_emb, V,
                            label_mode, niters, fusion_res, with_cameras,
                            "linspace") for s in range(S)]), 0, data_group)

    def stage_flops(self, V: int, num_keyframes: Optional[int] = None
                    ) -> dict:
        """Matmul/conv FLOPs of one ``run_device`` + fusion scene of V views
        by stage (``ops/flops.py``; the stages and keys of the JAX
        engine's ``pipeline_flops`` and ``tools/mfu_report.py``): the
        encoder and DINO over V views, the memory build over K keyframes,
        the render of V views, the keyframe head call, the other views'
        head call, and fusion at the mask resolution with 32 classes.  Each
        stage runs once under the counter on zeros of its shapes, on the
        engine's device, without gradients; kernels count the work they
        declare, so the count depends on the shapes only."""
        from panst3r_torch.engine.fusion import _fusion_full
        from panst3r_torch.ops.flops import count_flops

        c = self.model.config
        K = min(num_keyframes or self.num_keyframes, V)
        H, W = self.bucket.shape
        N = self.n_tokens
        mt = c.panoptic.mask_transformer
        dev, dt = self.device, self.dtype

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        img = zeros(V, H, W, 3, dtype=torch.uint8)
        x = zeros(V, N, c.encoder.embed_dim)
        pos = zeros(V, N, 2, dtype=torch.int64)
        y = zeros(V, N, c.decoder.dim)
        dino = zeros(V, N, c.dino.embed_dim)
        portrait = zeros(V, dtype=torch.bool)
        cls_emb = zeros(32, mt.lang_dim)
        cast = image_cast(img, self.amp)
        mem = memlib.init_memory(c.decoder.depth, 1, K * N, c.decoder.dim,
                                 dtype=dt, device=dev)

        def head(n, queries=None):
            return self.model.panoptic(
                (x[None, :n], y[None, :n], dino[None, :n]), cast[None, :n],
                pos[None, :n], portrait[None, :n], cls_emb, self.grid,
                memory_queries=queries,
                deep_supervision=False if queries is None else None)

        out = {}
        with torch.no_grad():
            out["encoder"] = count_flops(self.encode_batch, img)
            out["dino"] = count_flops(self.dino_batch, img)
            out["memory"] = count_flops(self.build_memory, x[:K], pos[:K])
            out["render"] = count_flops(self.render_batch, x, pos, mem)
            out["pan_joint"] = count_flops(head, K)
            out["pan_queries"] = count_flops(
                head, V - K, zeros(1, mt.num_queries, mt.hidden_dim)) \
                if V > K else 0.0
            out["fusion"] = count_flops(
                _fusion_full, zeros(1, mt.num_queries, 32,
                                    dtype=torch.float32),
                zeros(1, V, mt.num_queries, H // 2, W // 2,
                      dtype=torch.float32),
                (H, W), "sigmoid", 0.1, None, 0.25, 0.5, 2, 0.1)
        return out

    def pipeline_flops(self, V: int, num_keyframes: Optional[int] = None
                       ) -> float:
        """Matmul/conv FLOPs of one ``run_device`` + fusion scene: the sum
        of ``stage_flops``."""
        return sum(self.stage_flops(V, num_keyframes).values())

    def serve_stream(self, scenes, portrait, cls_embeddings,
                     unpack: bool = True, queue_depth: int = 2,
                     **serve_kw):
        """Pipelined serving over an iterable of scenes.  The calling
        thread uploads and launches one ``serve_device`` per scene and
        copies its wire into pinned host memory without waiting (a CUDA
        event marks the copy's end); a fetcher thread waits on each event
        and decodes, so the fetch of one scene overlaps the next scene's
        work.  At most ``queue_depth`` scenes are in flight.  Yields
        ``unpack_wire`` dicts (raw numpy wires with ``unpack=False``) in
        input order; an error in the fetcher is raised here."""
        port_dev, cls_emb = self._scene_args(portrait, cls_embeddings)
        V = int(port_dev.shape[0])
        kf = serve_kw.get("keyframe_mode", "linspace")
        K = min(serve_kw.get("num_keyframes") or self.num_keyframes, V)
        unpack_kw = {"with_cameras": serve_kw.get("with_cameras", False),
                     "with_keyframes": K if kf == "retrieval" else 0}
        wires: _queue.Queue = _queue.Queue(maxsize=max(1, queue_depth))
        out: _queue.Queue = _queue.Queue()
        done = object()

        def fetcher():
            failed = False
            while True:
                item = wires.get()
                if item is done:
                    out.put(done)
                    return
                if failed:
                    continue     # drain so that put() never blocks
                try:
                    host, event = item
                    if event is not None:
                        event.synchronize()
                    arr = fetch_wire(host)
                    out.put(self.unpack_wire(arr, V, **unpack_kw)
                            if unpack else arr)
                except BaseException as e:     # re-raised at the consumer
                    out.put(("__error__", e))
                    failed = True

        th = threading.Thread(target=fetcher, daemon=True)
        th.start()

        def drain(item):
            if isinstance(item, tuple) and item and item[0] == "__error__":
                raise item[1]
            return item

        try:
            for images in scenes:
                wire = self.serve_device(images, port_dev, cls_emb,
                                         **serve_kw)
                event = None
                if wire.device.type == "cuda":
                    host = torch.empty(wire.shape, dtype=wire.dtype,
                                       pin_memory=True)
                    host.copy_(wire, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    wire = host
                wires.put((wire, event))
                while not out.empty():
                    yield drain(out.get_nowait())
            wires.put(done)
            while True:
                item = out.get()
                if item is done:
                    break
                yield drain(item)
        finally:
            # abandoned generator or a failed fetch: unblock the fetcher
            # without deadlocking on a full queue
            while True:
                try:
                    wires.put_nowait(done)
                    break
                except _queue.Full:
                    try:
                        out.get(timeout=30)
                    except _queue.Empty:
                        break
            th.join(timeout=60)

    def unpack_wire(self, wire, V: int, with_cameras: bool = False,
                    with_keyframes: int = 0) -> dict:
        """Decode a fetched wire → {pan (V, H, W) int32, conf (V, H, W) f32
        in [0, 1], seg_ids / labels / selected (Q,)} (+ keyframes (K,),
        + focals (V,) and cam2world (V, 4, 4)).  Half-resolution planes are
        nearest-upsampled to the bucket shape."""
        wire = fetch_wire(wire)
        H, W = self.bucket.shape
        Q = self.model.config.panoptic.mask_transformer.num_queries
        cam_tail = 4 * (V + V * 16) if with_cameras else 0
        body = wire.size - 3 * Q - cam_tail - with_keyframes
        nf, nh = V * H * W, V * (H // 2) * (W // 2)
        nq = V * (H // 4) * (W // 4)
        # full: 2nf; mask: 2nh; hybrid: nf + nh; hybrid4: nf + nq
        layouts = {2 * nf: (nf, (H, W), nf, (H, W)),
                   2 * nh: (nh, (H // 2, W // 2), nh, (H // 2, W // 2)),
                   nf + nh: (nf, (H, W), nh, (H // 2, W // 2)),
                   nf + nq: (nf, (H, W), nq, (H // 4, W // 4))}
        if body not in layouts:
            raise ValueError(f"wire of {wire.size} values does not fit V={V} "
                             f"at ({H}, {W})")
        n_pan, (ph, pw), n_conf, (ch, cw) = layouts[body]
        pan = wire[:n_pan].astype(np.int32).reshape(V, ph, pw)
        conf = (wire[n_pan:n_pan + n_conf].astype(np.float32)
                .reshape(V, ch, cw) / 255.0)
        if (ph, pw) != (H, W):
            pan = pan.repeat(H // ph, axis=1).repeat(W // pw, axis=2)
        if (ch, cw) != (H, W):
            conf = conf.repeat(H // ch, axis=1).repeat(W // cw, axis=2)
        n2 = n_pan + n_conf
        res = {"pan": pan, "conf": conf,
               "seg_ids": wire[n2:n2 + Q].astype(np.int32),
               "labels": wire[n2 + Q:n2 + 2 * Q].astype(np.int32),
               "selected": wire[n2 + 2 * Q:n2 + 3 * Q] != 0}
        tail = n2 + 3 * Q
        if with_keyframes:
            res["keyframes"] = wire[tail:tail + with_keyframes].astype(
                np.int32)
            tail += with_keyframes
        if with_cameras:
            cam = np.frombuffer(wire[tail:].astype(np.uint8).tobytes(),
                                np.float32)
            res["focals"] = cam[:V].copy()
            res["cam2world"] = cam[V:].reshape(V, 4, 4).copy()
        return res


class MultiBucketEngine:
    """Inference over scenes with mixed aspect-ratio buckets (the JAX
    engine's ``MultiBucketEngine``): views group into resolution buckets,
    each bucket runs its own ``InferenceEngine`` stages over the one shared
    model, and everything meets in a SHARED token memory (capacity: the
    keyframes' tokens over all buckets) and the joint multi-bucket
    mask-transformer decode of the keyframes.  The other views take the
    frozen keyframe queries per bucket."""

    def __init__(self, model: PanSt3R, num_keyframes: int = 16,
                 chunk: int = 4, amp: bool = True, device=None):
        self.device = resolve_device(device)
        self.num_keyframes = num_keyframes
        self.chunk = chunk
        self.amp = amp
        self.dtype = torch.bfloat16 if amp else torch.float32
        # cast once: every bucket engine shares these parameters
        model = model.to(self.device)
        if amp:
            model = model.to(torch.bfloat16)
        self.model = model.eval()
        self._engines: dict[Bucket, InferenceEngine] = {}

    def _engine(self, bucket: Bucket) -> InferenceEngine:
        if bucket not in self._engines:
            self._engines[bucket] = InferenceEngine(
                self.model, bucket, num_keyframes=self.num_keyframes,
                chunk=self.chunk, amp=self.amp, device=self.device)
        return self._engines[bucket]

    @staticmethod
    def _groups(idxs, buckets) -> dict[Bucket, list[int]]:
        groups: dict[Bucket, list[int]] = {}
        for i in idxs:
            groups.setdefault(buckets[i], []).append(i)
        return groups

    @torch.inference_mode()
    def run_device(self, images, portrait, cls_embeddings,
                   num_keyframes: Optional[int] = None) -> dict:
        """images: per-view (H_i, W_i, 3) arrays (uint8 or float in
        [-1, 1]), each in some bucket shape; portrait (V,) bool.  Returns
        device tensors in input order: {pointmaps_raw: per-view (H_i, W_i,
        7), pred_logits (Q, ncls), pred_masks: per-view (Q, H_i/2, W_i/2),
        out_queries, keyframes, true_shapes}."""
        dev = self.device
        V = len(images)
        K = min(num_keyframes or self.num_keyframes, V)
        c = self.model.config
        cls_emb = torch.as_tensor(cls_embeddings, device=dev).to(self.dtype)
        portrait = torch.as_tensor(np.asarray(portrait), device=dev)
        buckets = [Bucket(*im.shape[:2]) for im in images]
        keyframes = select_keyframes_linspace(V, K)
        kf_set = set(keyframes)

        # upload and encode per bucket (chunks of ``chunk`` views)
        img, enc = {}, {}
        for bucket, idxs in self._groups(range(V), buckets).items():
            stack = torch.stack([torch.as_tensor(images[i])
                                 for i in idxs]).to(dev)
            x, pos = self._engine(bucket).encode_batch(stack)
            for j, i in enumerate(idxs):
                img[i], enc[i] = stack[j], (x[j], pos[j])

        def stacked(idxs, part):
            return torch.stack([enc[i][part] for i in idxs])

        # shared memory over every bucket's keyframe tokens; keyframes are
        # injected per bucket group on the [init, +1, ...] schedule
        capacity = sum(self._engine(buckets[i]).n_tokens for i in keyframes)
        mem = memlib.init_memory(c.decoder.depth, 1, capacity, c.decoder.dim,
                                 dtype=self.dtype, device=dev)
        for bucket, idxs in self._groups(keyframes, buckets).items():
            grid = self._engine(bucket).grid
            x, pos = stacked(idxs, 0), stacked(idxs, 1)
            start = 0
            for nb in c.mem_batches(len(idxs)):
                mem = self.model.decoder_update(
                    x[None, start:start + nb], pos[None, start:start + nb],
                    mem, grid)[0]
                start += nb

        def render_group(idxs):
            """Render + DINO per bucket group: (groups, {view: (pointmap,
            decoder features, DINO tokens)})."""
            groups = self._groups(idxs, buckets)
            outs = {}
            for bucket, gidx in groups.items():
                eng = self._engine(bucket)
                pm, y = eng.render_batch(stacked(gidx, 0), stacked(gidx, 1),
                                         mem)
                dino = eng.dino_batch(torch.stack([img[i] for i in gidx]))
                for j, i in enumerate(gidx):
                    outs[i] = (pm[j], y[j], dino[j])
            return groups, outs

        def head_inputs(gidx, outs):
            return ((stacked(gidx, 0)[None],
                     torch.stack([outs[i][1] for i in gidx])[None],
                     torch.stack([outs[i][2] for i in gidx])[None]),
                    image_cast(torch.stack([img[i] for i in gidx]),
                               self.amp)[None],
                    stacked(gidx, 1)[None], portrait[gidx][None])

        # the joint multi-bucket panoptic decode over the keyframes
        kf_groups, kf_out = render_group(keyframes)
        parts = [head_inputs(gidx, kf_out) for gidx in kf_groups.values()]
        feats = tuple([p[0][k] for p in parts] for k in range(3))
        panout = self.model.panoptic(
            feats, [p[1] for p in parts], [p[2] for p in parts],
            [p[3] for p in parts], cls_emb,
            [self._engine(b).grid for b in kf_groups],
            deep_supervision=False)
        pred_masks = {}
        for b_i, gidx in enumerate(kf_groups.values()):
            for j, i in enumerate(gidx):
                pred_masks[i] = panout["pred_masks"][b_i][0, j]

        # the other views: render + frozen-query decode per bucket
        all_out = kf_out
        not_kf = [i for i in range(V) if i not in kf_set]
        if not_kf:
            nk_groups, nk_out = render_group(not_kf)
            for bucket, gidx in nk_groups.items():
                f, im, pos, port = head_inputs(gidx, nk_out)
                out_i = self.model.panoptic(
                    f, im, pos, port, cls_emb, self._engine(bucket).grid,
                    memory_queries=panout["out_queries"])
                for j, i in enumerate(gidx):
                    pred_masks[i] = out_i["pred_masks"][0, j]
            all_out = {**kf_out, **nk_out}

        return {
            "pointmaps_raw": [all_out[i][0] for i in range(V)],
            "pred_logits": panout["pred_logits"][0],
            "pred_masks": [pred_masks[i] for i in range(V)],
            "out_queries": panout["out_queries"][0],
            "keyframes": keyframes,
            "true_shapes": [tuple(b.shape) for b in buckets],
        }

    def run(self, images, portrait, cls_embeddings,
            num_keyframes: Optional[int] = None) -> dict:
        """run_device with the tensors returned as host numpy arrays
        (f32)."""
        out = self.run_device(images, portrait, cls_embeddings, num_keyframes)

        def host(t):
            return t.float().cpu().numpy()

        return {"pointmaps_raw": [host(t) for t in out["pointmaps_raw"]],
                "pred_logits": host(out["pred_logits"]),
                "pred_masks": [host(t) for t in out["pred_masks"]],
                "out_queries": host(out["out_queries"]),
                "keyframes": out["keyframes"],
                "true_shapes": out["true_shapes"]}

    def fuse(self, out: dict, true_shapes=None, **fusion_kw) -> list[dict]:
        """Joint fusion of a mixed-bucket scene on the engine's device:
        per-view upsample to each view's true shape, zero-pad to the
        largest, fuse jointly, crop (``panoptic_fusion_multi_ar``)."""
        from panst3r_torch.engine.fusion import panoptic_fusion_multi_ar

        dev = self.device
        with torch.inference_mode():
            return panoptic_fusion_multi_ar(
                torch.as_tensor(out["pred_logits"], device=dev),
                [torch.as_tensor(m, device=dev) for m in out["pred_masks"]],
                list(true_shapes or out["true_shapes"]), **fusion_kw)


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (S, n) of each scene of ``t`` (S, V, …) → (S, n, …)."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


def fetch_wire(wire) -> np.ndarray:
    """A wire (device or host tensor, or numpy) as a host numpy array."""
    if torch.is_tensor(wire):
        return wire.cpu().numpy()
    return np.asarray(wire)
