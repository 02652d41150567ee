"""Headless serving daemon: POST scenes, get panoptic results (counterpart
of panst3r_tpu/apps/serve.py).

A stdlib HTTP server in front of the wire path
(``InferenceEngine.serve_device``): the engine stays warm, and each request
is one upload, one pipeline and one wire download on the card.

Protocol (binary npz both ways):

  POST /reconstruct   body: npz{images (V,H,W,3) uint8 [, portrait (V,)]}
                      query: ?cameras=1&keyframes=retrieval&fusion=mask
  → 200, npz{pan (V,H,W) int32, conf (V,H,W) f32, seg_ids, labels,
             selected [, focals, cam2world, keyframes]}

  GET /healthz        → 200 "ok".

A streaming SLAM session (``engine/slam.py::IncrementalFrontend`` over
HTTP: one encoder pass and one render per frame against the growing
keyframe memory):

  POST /slam/start    query: ?sim_threshold=0.9&max_interval=5
  POST /slam/frame    body: npz{image (H,W,3) uint8}
                      → npz{is_keyframe [, pts3d, pts3d_local, conf] f16}
  POST /slam/finish   → npz{poses (N,4,4), poses_init, frame_ids,
                        keyframe_ids} (the pose-graph refinement; frame 0
                        is rendered against the final memory, as
                        ``apps/slam.py::run_slam`` does) and ends the
                        session.

A malformed request, a frame before ``/slam/start`` and a finish with
fewer than two frames get 400 with the reason, and the server stays up.

Requests are served on threads; only ``SceneServer`` touches the card, and
only under its lock.

Run:  python -m panst3r_torch.apps.serve --preset v1 [--device cpu]
      [--checkpoint ckpt] [--bucket 512x384] [--port 8030] [--warm 8]
"""
from __future__ import annotations

import argparse
import functools
import http.server
import io
import threading
from urllib.parse import parse_qs, urlparse

import numpy as np


class SceneServer:
    """Engine wrapper: one serve call per request, serialized by a lock
    (the card is one serial resource; concurrent requests queue)."""

    def __init__(self, engine, cls_emb: np.ndarray):
        self.engine = engine
        self.cls_emb = np.asarray(cls_emb)
        self.lock = threading.Lock()

    def reconstruct(self, images: np.ndarray, portrait: np.ndarray,
                    with_cameras: bool = False,
                    keyframe_mode: str = "linspace",
                    fusion_res: str = "full") -> dict:
        from panst3r_torch.engine.inference import fetch_wire

        V = images.shape[0]
        K = min(self.engine.num_keyframes, V)
        with self.lock:
            wire = fetch_wire(self.engine.serve_device(
                images, portrait, self.cls_emb, with_cameras=with_cameras,
                keyframe_mode=keyframe_mode, fusion_res=fusion_res))
        return self.engine.unpack_wire(
            wire, V, with_cameras=with_cameras,
            with_keyframes=K if keyframe_mode == "retrieval" else 0)

    # ------------------------------------------------- streaming SLAM ----

    def slam_start(self, sim_threshold: float = 0.9, max_interval: int = 5):
        from panst3r_torch.engine.slam import IncrementalFrontend

        with self.lock:
            self._slam = IncrementalFrontend(
                self.engine, sim_threshold=sim_threshold,
                max_interval=max_interval)
            self._slam_maps = {}                  # frame id -> pointmaps
            self._slam_kf = []
            self._slam_n = 0
            self._slam_frame0 = None

    def slam_frame(self, image: np.ndarray) -> dict:
        with self.lock:
            if getattr(self, "_slam", None) is None:
                raise ValueError("no SLAM session (POST /slam/start first)")
            fid = self._slam_n
            self._slam_n += 1
            out = self._slam.process(image, fid)
            res = {"is_keyframe": np.asarray(out["is_keyframe"])}
            if out["is_keyframe"]:
                self._slam_kf.append(fid)
            if out["pointmaps_raw"] is not None:
                post = _postprocess(out["pointmaps_raw"])
                self._slam_maps[fid] = post
                for k, v in post.items():
                    res[k] = v.astype(np.float16)
            else:
                # the first frame: rendered at /slam/finish against the
                # final memory
                self._slam_frame0 = np.asarray(image)
            return res

    def slam_finish(self) -> dict:
        from panst3r_torch.engine.slam import refine_scene_poses

        with self.lock:
            if getattr(self, "_slam", None) is None:
                raise ValueError("no SLAM session")
            try:
                st = self._slam.state
                if self._slam_frame0 is not None and st is not None \
                        and st.mem is not None:
                    self._slam_maps[0] = _postprocess(
                        self._slam.render(self._slam_frame0))
                if not self._slam_maps:
                    raise ValueError(
                        "SLAM session has no decodable frames yet "
                        "(need >= 2 frames)")
                order = sorted(self._slam_maps)
                maps = {k: np.stack([self._slam_maps[i][k] for i in order])
                        for k in self._slam_maps[order[0]]}
                refined, init, _ = refine_scene_poses(
                    maps, device=self.engine.device)
                return {"poses": refined.cpu().numpy(),
                        "poses_init": init.cpu().numpy(),
                        "frame_ids": np.asarray(order, np.int32),
                        "keyframe_ids": np.asarray(self._slam_kf,
                                                   np.int32)}
            finally:
                self._slam = None


def _postprocess(raw: np.ndarray) -> dict:
    """Raw (H, W, 7) pointmaps → {pts3d, pts3d_local, conf} as f32
    numpy."""
    import torch

    from panst3r_torch.models.decoder import postprocess

    post = postprocess(torch.as_tensor(raw, dtype=torch.float32))
    return {k: v.numpy() for k, v in post.items()}


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "panst3r_torch-serve/1.0"

    def __init__(self, *args, scene_server: SceneServer, **kw):
        self.scene_server = scene_server
        super().__init__(*args, **kw)

    def log_message(self, *a):
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/healthz"):
            self._send(200, b"ok", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        try:
            url = urlparse(self.path)
            q = parse_qs(url.query)
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            srv = self.scene_server
            if url.path == "/reconstruct":
                data = np.load(io.BytesIO(body))
                images = data["images"]
                portrait = (data["portrait"] if "portrait" in data
                            else np.zeros(images.shape[0], bool))
                out = srv.reconstruct(
                    images, portrait,
                    with_cameras=q.get("cameras", ["0"])[0] == "1",
                    keyframe_mode=q.get("keyframes", ["linspace"])[0],
                    fusion_res=q.get("fusion", ["full"])[0])
            elif url.path == "/slam/start":
                srv.slam_start(
                    sim_threshold=float(q.get("sim_threshold", ["0.9"])[0]),
                    max_interval=int(q.get("max_interval", ["5"])[0]))
                self._send(200, b"ok", "text/plain")
                return
            elif url.path == "/slam/frame":
                out = srv.slam_frame(np.load(io.BytesIO(body))["image"])
            elif url.path == "/slam/finish":
                out = srv.slam_finish()
            else:
                self._send(404, b"not found", "text/plain")
                return
            buf = io.BytesIO()
            np.savez_compressed(buf, **out)
            self._send(200, buf.getvalue())
        except Exception as e:  # the client gets the reason; the server lives
            self._send(400, f"error: {e}".encode(), "text/plain")


def make_server(scene_server: SceneServer, host: str, port: int):
    handler = functools.partial(_Handler, scene_server=scene_server)
    return http.server.ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    from panst3r_torch.apps.common import PRESETS, build_engine
    from panst3r_torch.core.bucketing import Bucket
    from panst3r_torch.engine.inference import fetch_wire

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="v1", choices=PRESETS)
    ap.add_argument("--checkpoint", default=None,
                    help="a save_checkpoint directory or a reference "
                         "torch checkpoint file")
    ap.add_argument("--bucket", default="512x384",
                    help="WxH serving resolution bucket")
    ap.add_argument("--num-keyframes", type=int, default=4)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8030)
    ap.add_argument("--warm", type=int, default=0, metavar="V",
                    help="serve one V-view scene of zeros before accepting "
                         "traffic (the kernels are built and the card "
                         "warm when /healthz first answers)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    W, H = (int(x) for x in args.bucket.split("x"))
    engine, _, cls_emb = build_engine(
        args.preset, Bucket(H, W), checkpoint=args.checkpoint,
        num_keyframes=args.num_keyframes, device=args.device)
    if args.warm:
        print(f"warming with a {args.warm}-view scene…", flush=True)
        fetch_wire(engine.serve_device(
            np.zeros((args.warm, H, W, 3), np.uint8),
            np.zeros(args.warm, bool), cls_emb))
    srv = make_server(SceneServer(engine, cls_emb), args.host, args.port)
    print(f"serving at http://{args.host}:{srv.server_address[1]}"
          f"/reconstruct", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
