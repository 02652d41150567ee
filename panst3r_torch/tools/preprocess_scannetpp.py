"""ScanNet++ panoptic preprocessing (counterpart of
tools/preprocess_scannetpp.py, on the port's own modules).

COLMAP text parsing, fisheye / OpenCV undistortion, mesh-vertex panoptic
labels ``inst * cls_sep + cls`` from a class list with a crowd mapping,
per-view depth and instance-label rendering by the host rasterizer
(``panst3r_torch/native/rasterizer.cpp`` through
``panst3r_torch.native.rasterize_mesh``: no anti-aliasing, so label edges
keep their ids), id2rgb panoptic PNGs with a minimum segment area, and
per-scene and global metadata npz.  It writes the layout that
``panst3r_torch/data/scannetpp.py`` reads.  The mesh loader is a
self-contained PLY reader (ascii and binary little-endian).

Usage:
  python -m panst3r_torch.tools.preprocess_scannetpp --root <scannetpp_root> \
      --pairs-dir <precomputed_pairs> --output-dir <out> \
      --class-list <top100.txt> [--mapping-file map.csv]
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import struct

import numpy as np

CLS_SEP = 256
MIN_SEG_AREA = 100  # px: smaller segments are dropped


# --------------------------------------------------------------- COLMAP ---

def pose_from_qwxyz_txyz(elems) -> np.ndarray:
    """COLMAP images.txt stores world→cam (qw qx qy qz tx ty tz);
    return cam→world."""
    qw, qx, qy, qz, tx, ty, tz = map(float, elems)
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    t = np.array([tx, ty, tz])
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    return np.linalg.inv(w2c)


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    """COLMAP pixel centers at integer coords; OpenCV at half-integers."""
    K = K.copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def load_sfm(sfm_dir: str) -> tuple[dict, dict]:
    """Parse cameras.txt + images.txt → (img_idx by name, img_infos)."""
    with open(osp.join(sfm_dir, "cameras.txt")) as f:
        raw = [l for l in f.read().splitlines() if not l.startswith("#")]
    intrinsics = {}
    for cam in raw:
        parts = cam.split(" ")
        intrinsics[int(parts[0])] = [parts[1]] + [float(v)
                                                  for v in parts[2:]]

    with open(osp.join(sfm_dir, "images.txt")) as f:
        raw = [l for l in f.read().splitlines() if not l.startswith("#")]
    img_idx, img_infos = {}, {}
    for image_line in raw[0::2]:
        e = image_line.split(" ")
        idx = e[0]
        name = e[-1]
        for prefix in ("iphone/", "video/"):
            if name.startswith(prefix):
                name = name[len(prefix):]
        img_idx[name] = idx
        img_infos[idx] = dict(
            intrinsics=intrinsics[int(e[-2])],
            path=name,
            cam_to_world=pose_from_qwxyz_txyz(e[1:-2]),
        )
    return img_idx, img_infos


# ------------------------------------------------------------------ PLY ---

_PLY_TYPES = {
    "char": "b", "uchar": "B", "int8": "b", "uint8": "B",
    "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
    "int": "i", "uint": "I", "int32": "i", "uint32": "I",
    "float": "f", "float32": "f", "double": "d", "float64": "d",
}


def load_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader → (vertices (N,3) float32, faces (F,3) int32)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = f.readline().split()[1].decode()
        elements = []  # (name, count, [(prop_type, prop_name) or list-prop])
        while True:
            line = f.readline().decode().strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element":
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:
                    elements[-1][2].append((parts[1], parts[2]))

        verts = faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                if name == "vertex":
                    names = [p[1] for p in props]
                    data = np.loadtxt(f, max_rows=count, dtype=np.float64)
                    data = np.atleast_2d(data)
                    ix = [names.index(a) for a in "xyz"]
                    verts = data[:, ix].astype(np.float32)
                elif name == "face":
                    rows = [f.readline().split() for _ in range(count)]
                    faces = np.array([[int(r[1]), int(r[2]), int(r[3])]
                                      for r in rows], np.int32)
                else:
                    for _ in range(count):
                        f.readline()
            else:
                endian = "<" if "little" in fmt else ">"
                if name == "vertex":
                    fields = [(p[1], endian + _PLY_TYPES[p[0]])
                              for p in props]
                    dt = np.dtype(fields)
                    buf = f.read(dt.itemsize * count)
                    data = np.frombuffer(buf, dt, count)
                    verts = np.stack([data["x"], data["y"], data["z"]],
                                     -1).astype(np.float32)
                elif name == "face":
                    p = props[0]
                    cnt_t = endian + _PLY_TYPES[p[1]]
                    idx_t = endian + _PLY_TYPES[p[2]]
                    cnt_sz = struct.calcsize(cnt_t)
                    idx_sz = struct.calcsize(idx_t)
                    out = np.empty((count, 3), np.int32)
                    for i in range(count):
                        n = struct.unpack(cnt_t, f.read(cnt_sz))[0]
                        vals = struct.unpack(endian + _PLY_TYPES[p[2]] * n,
                                             f.read(idx_sz * n))
                        out[i] = vals[:3]
                    faces = out
                else:
                    raise ValueError(f"unhandled binary element {name}")
    assert verts is not None and faces is not None
    return verts, faces


# ------------------------------------------------------------ semantics ---

def read_semantics(segments_path: str, annotations_path: str,
                   lbl2id: dict[str, int], crowd_classes: set[str],
                   num_points: int, cls_sep: int = CLS_SEP,
                   export_crowd: bool = False):
    """Mesh vertices → packed ``inst * cls_sep + cls`` ids."""
    with open(segments_path) as f:
        seg = json.load(f)
    seg_indices = np.asarray(seg["segIndices"])

    with open(annotations_path) as f:
        annotations = json.load(f)

    pts_pan_id = np.zeros(num_points, np.int64)
    segments = []
    inst_id = 1
    for info in annotations["segGroups"]:
        if info["label"] not in lbl2id:
            continue
        cls_id = lbl2id[info["label"]]
        iscrowd = info["label"] in crowd_classes
        if iscrowd and not export_crowd:
            continue
        # segGroups list segment ids; map to vertex indices.
        vert_mask = np.isin(seg_indices, np.asarray(info["segments"]))
        if not vert_mask.any():
            vert_idx = np.asarray(info["segments"])
            vert_idx = vert_idx[vert_idx < num_points]
            vert_mask = np.zeros(num_points, bool)
            vert_mask[vert_idx] = True
        pts_pan_id[vert_mask] = inst_id * cls_sep + cls_id
        segments.append(dict(id=inst_id * cls_sep + cls_id,
                             instance_id=inst_id, class_id=cls_id,
                             orig_class_name=info["label"],
                             iscrowd=iscrowd))
        inst_id += 1
    return segments, pts_pan_id


# ---------------------------------------------------------- undistortion ---

def undistort_image(intrinsics: list, rgb: np.ndarray):
    """The image undistorted (fisheye or plain OpenCV model) and its new
    intrinsics."""
    import cv2

    camera_type = intrinsics[0]
    width, height = int(intrinsics[1]), int(intrinsics[2])
    fx, fy, cx, cy = intrinsics[3:7]
    distortion = np.array(intrinsics[7:])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    K = colmap_to_opencv_intrinsics(K)

    if camera_type == "OPENCV_FISHEYE":
        new_K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
            K, distortion[:4], (width, height), np.eye(3), balance=0.0)
        new_K[0, 2] = width / 2.0
        new_K[1, 2] = height / 2.0
        m1, m2 = cv2.fisheye.initUndistortRectifyMap(
            K, distortion[:4], np.eye(3), new_K, (width, height),
            cv2.CV_32FC1)
    else:
        new_K, _ = cv2.getOptimalNewCameraMatrix(
            K, distortion, (width, height), 1, (width, height), True)
        m1, m2 = cv2.initUndistortRectifyMap(
            K, distortion, np.eye(3), new_K, (width, height), cv2.CV_32FC1)
    out = cv2.remap(rgb, m1, m2, interpolation=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REFLECT_101)
    return opencv_to_colmap_intrinsics(new_K), out


# -------------------------------------------------------------- renderer ---

def render_view(verts_world: np.ndarray, faces: np.ndarray,
                face_labels: np.ndarray, cam_to_world: np.ndarray,
                K: np.ndarray, H: int, W: int):
    """Depth (m) + panoptic-id map via the native rasterizer."""
    from panst3r_torch.native import rasterize_mesh

    w2c = np.linalg.inv(cam_to_world)
    verts_cam = verts_world @ w2c[:3, :3].T + w2c[:3, 3]
    K_cv = colmap_to_opencv_intrinsics(K.astype(np.float64))
    return rasterize_mesh(verts_cam.astype(np.float32), faces, face_labels,
                          K_cv.astype(np.float32), H, W)


def face_labels_from_vertices(faces: np.ndarray,
                              vert_labels: np.ndarray) -> np.ndarray:
    """Majority (here: first-nonzero / first-vertex) label per face."""
    tri = vert_labels[faces]                      # (F, 3)
    lab = tri[:, 0]
    lab = np.where(lab == 0, tri[:, 1], lab)
    lab = np.where(lab == 0, tri[:, 2], lab)
    return lab.astype(np.int32)


# ----------------------------------------------------------------- main ---

def rescale(img, K, target_resolution, nearest=False):
    import cv2

    H, W = img.shape[:2]
    tw, th = target_resolution
    scale = min(tw / W, th / H)
    out = cv2.resize(img, (int(round(W * scale)), int(round(H * scale))),
                     interpolation=cv2.INTER_NEAREST if nearest
                     else cv2.INTER_AREA)
    K2 = K.copy()
    K2[:2] *= scale
    return out, K2


def process_scene(root: str, scene: str, lbl2id: dict, crowd: set,
                  pairs_dir: str, output_dir: str, target_resolution,
                  cls_sep: int = CLS_SEP, export_crowd: bool = False):
    import cv2

    from panst3r_torch.data.utils import id2rgb

    scene_dir = osp.join(root, "data", scene)
    out_scene = osp.join(output_dir, scene)
    for sub in ("images", "depth", "panoptic"):
        os.makedirs(osp.join(out_scene, sub), exist_ok=True)

    verts, faces = load_ply_mesh(
        osp.join(scene_dir, "scans", "mesh_aligned_0.05.ply"))
    segments, pts_pan = read_semantics(
        osp.join(scene_dir, "scans", "segments.json"),
        osp.join(scene_dir, "scans", "segments_anno.json"),
        lbl2id, crowd, len(verts), cls_sep, export_crowd)
    flabels = face_labels_from_vertices(faces, pts_pan)

    sel_path = osp.join(pairs_dir, scene, "selected_pairs.npz")
    sel = np.load(sel_path)
    selection, pairs = sel["selection"], sel["pairs"]

    img_idx, img_infos = load_sfm(osp.join(scene_dir, "dslr", "colmap"))

    trajectories, intrinsics_out, kept = [], [], []
    for imgname in selection:
        key = imgname + ".JPG" if (imgname + ".JPG") in img_idx \
            else imgname + ".jpg"
        if key not in img_idx:
            print(f"WARN: {scene}/{imgname} not in sfm; skipping")
            continue
        info = img_infos[img_idx[key]]
        rgb = cv2.cvtColor(
            cv2.imread(osp.join(scene_dir, "dslr", "resized_images", key)),
            cv2.COLOR_BGR2RGB)
        K_new, und = undistort_image(info["intrinsics"], rgb)
        und, K_s = rescale(und, K_new, target_resolution)
        H, W = und.shape[:2]

        depth, pan = render_view(verts, faces, flabels,
                                 info["cam_to_world"], K_s, H, W)

        # segments under MIN_SEG_AREA pixels are dropped
        ids, counts = np.unique(pan[pan > 0], return_counts=True)
        for pid, cnt in zip(ids, counts):
            if cnt < MIN_SEG_AREA:
                pan[pan == pid] = 0

        base = imgname
        cv2.imwrite(osp.join(out_scene, "images", base + ".jpg"),
                    cv2.cvtColor(und, cv2.COLOR_RGB2BGR))
        cv2.imwrite(osp.join(out_scene, "depth", base + ".png"),
                    (np.clip(depth, 0, 65.535) * 1000).astype(np.uint16))
        cv2.imwrite(osp.join(out_scene, "panoptic", base + ".png"),
                    cv2.cvtColor(id2rgb(pan.astype(np.int64)),
                                 cv2.COLOR_RGB2BGR))
        trajectories.append(info["cam_to_world"])
        intrinsics_out.append(K_s)
        kept.append(imgname)

    # Crowd instance ids (only present with --export-crowd): the eval
    # harness needs them for panopticapi's iscrowd matching rules
    # (engine/eval.py scene_pq).
    crowd_ids = np.asarray(sorted(s["instance_id"] for s in segments
                                  if s["iscrowd"]), np.int64)
    np.savez(osp.join(out_scene, "scene_metadata.npz"),
             trajectories=np.stack(trajectories),
             intrinsics=np.stack(intrinsics_out),
             images=np.asarray(kept), pairs=pairs, cls_sep=cls_sep,
             crowd_inst_ids=crowd_ids)
    return segments


def merge_metadata(output_dir: str, scenes: list[str], cls_sep: int):
    """Concatenates the per-scene metadata into all_metadata.npz."""
    offset = 0
    all_scenes, sceneids, images, intrinsics, trajectories, pairs, counts = \
        [], [], [], [], [], [], []
    crowd = []
    for sidx, scene in enumerate(scenes):
        with np.load(osp.join(output_dir, scene, "scene_metadata.npz"),
                     allow_pickle=True) as d:
            n = d["images"].shape[0]
            all_scenes.append(scene)
            sceneids.extend([sidx] * n)
            images.append(d["images"])
            intrinsics.append(d["intrinsics"])
            trajectories.append(d["trajectories"])
            p = d["pairs"].copy().astype(np.float64)
            p[:, 0:2] += offset
            pairs.append(p)
            counts.append(offset)
            offset += n
            crowd.append(d["crowd_inst_ids"] if "crowd_inst_ids" in d
                         else np.zeros(0, np.int64))
    np.savez(osp.join(output_dir, "all_metadata.npz"),
             counts=counts, scenes=np.asarray(all_scenes),
             sceneids=np.asarray(sceneids),
             images=np.concatenate(images),
             intrinsics=np.concatenate(intrinsics),
             trajectories=np.concatenate(trajectories),
             pairs=np.concatenate(pairs), cls_sep=cls_sep,
             scene_crowd_inst_ids=np.asarray(crowd, object))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="scannetpp root")
    ap.add_argument("--pairs-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--class-list", required=True,
                    help="text file, one class name per line (top-100)")
    ap.add_argument("--mapping-file", default=None,
                    help="csv: raw_label,mapped_label[,iscrowd]")
    ap.add_argument("--target-resolution", type=int, nargs=2,
                    default=[1168, 770])
    ap.add_argument("--cls-sep", type=int, default=CLS_SEP)
    ap.add_argument("--export-crowd", action="store_true")
    args = ap.parse_args(argv)

    classes = [l.strip() for l in open(args.class_list) if l.strip()]
    lbl2id = {c: i for i, c in enumerate(classes)}
    crowd = set()
    if args.mapping_file:
        import csv

        with open(args.mapping_file) as f:
            for row in csv.reader(f):
                if len(row) >= 3 and row[2].strip() in ("1", "true", "True"):
                    crowd.add(row[0].strip())

    os.makedirs(args.output_dir, exist_ok=True)
    with open(osp.join(args.output_dir, "categories.json"), "w") as f:
        json.dump([{"id": i, "name": c} for i, c in enumerate(classes)], f)

    scenes = sorted(os.listdir(args.pairs_dir))
    for scene in scenes:
        print(f"processing {scene}")
        process_scene(args.root, scene, lbl2id, crowd, args.pairs_dir,
                      args.output_dir, tuple(args.target_resolution),
                      args.cls_sep, args.export_crowd)
    merge_metadata(args.output_dir, scenes, args.cls_sep)
    print("all done")


if __name__ == "__main__":
    main()
