"""CO3Dv2 scene dataset — real archive format
(sgm/data/co3d.py:315-700 ``CO3Dv2Wrapper`` + the pytorch3d
JsonIndexDataset machinery it builds on); a port of the JAX package's
``data/co3d.py``, numpy on the host.

Archive layout::

    root/<category>/frame_annotations.jgz       gzipped JSON list of frames
    root/<category>/sequence_annotations.jgz    gzipped JSON list of seqs
    root/<category>/set_lists/set_lists_<subset>.json
        {"train": [[seq, frame_number, image_path], ...], "val": ..., ...}
    root/<frame.image.path>                     JPG frames
    root/<frame.mask.path>                      PNG fg-probability masks

Frame annotation schema (co3d.dataset.data_types.FrameAnnotation)::

    {"sequence_name", "frame_number", "frame_timestamp",
     "image": {"path", "size": [H, W]},
     "mask":  {"path", "mass"},
     "viewpoint": {"R": 3x3, "T": 3, "focal_length": 2,
                   "principal_point": 2,
                   "intrinsics_format": "ndc_isotropic" |
                                        "ndc_norm_image_bounds"}}

Faithful semantics (refs into the reference's sgm/data/co3d.py):
- sequences with <=10 frames dropped, 2 known-bad sequences removed
  (:497-516); random sample of ``sample_batch_size`` frames sorted by
  frame_timestamp (:530-560)
- box crop from the mask at threshold 0.4 with context 0.3, resize-longest
  to 256 + zero pad (pytorch3d _get_bbox_from_mask/_get_clamp_bbox/
  _resize_image; wrapper flags :376-379)
- white-composited ``images`` = rgb*fg + (1-fg) (:571-572); ``frames`` in
  [-1,1]; mirror padding to num_frames=20 (:590-598)
- pixelnerf cameras: pytorch3d NDC -> OpenCV K/R/T
  (opencv_from_cameras_projection) -> homogeneous c2w with y/z columns
  flipped (OpenGL), K rows /256, 25-dim tensor, optional pose normalization
  to radius 1.5 (:644-672)
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from v3d_tpu_torch.data.gobjaverse import normalize_poses
from v3d_tpu_torch.data.objaverse import video_collate

# sequences the reference hard-removes (co3d.py:510-516)
REMOVE_SEQUENCES = ("411_55952_107659", "376_42884_85882")


def load_jgz(path: str):
    with gzip.open(path, "rt", encoding="utf8") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# box crop + resize (pytorch3d image_utils semantics)
# ---------------------------------------------------------------------------

def get_bbox_from_mask(mask: np.ndarray, thr: float = 0.4) -> Tuple[int, int, int, int]:
    """xywh bbox of mask>thr; threshold decays by 0.05 until non-empty
    (pytorch3d _get_bbox_from_mask)."""
    masks_for_box = mask > thr
    while masks_for_box.sum() <= 1.0 and thr > 0:
        thr -= 0.05
        masks_for_box = mask > thr
    if masks_for_box.sum() <= 1.0:
        return 0, 0, mask.shape[1], mask.shape[0]
    xs = np.flatnonzero(masks_for_box.sum(axis=0) > 0)
    ys = np.flatnonzero(masks_for_box.sum(axis=1) > 0)
    return int(xs[0]), int(ys[0]), int(xs[-1] - xs[0]), int(ys[-1] - ys[0])


def clamp_bbox(bbox_xywh, context: float, h: int, w: int) -> Tuple[int, int, int, int]:
    """Expand xywh by ``context`` per side, convert to clipped xyxy
    (pytorch3d _get_clamp_bbox + image-bound clamping)."""
    x, y, bw, bh = [float(v) for v in bbox_xywh]
    if context > 0:
        x -= bw * context / 2
        y -= bh * context / 2
        bw *= 1 + context
        bh *= 1 + context
    bw, bh = max(bw, 2.0), max(bh, 2.0)
    x0, y0 = int(max(x, 0)), int(max(y, 0))
    x1, y1 = int(min(x + bw + 1, w)), int(min(y + bh + 1, h))
    return x0, y0, x1, y1


def resize_longest(img: np.ndarray, out_size: int, mode: str = "bilinear"
                   ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Scale so the longest side == out_size, zero-pad bottom/right
    (pytorch3d _resize_image).  img: (H,W,C) -> (out,out,C), scale,
    valid-region mask (out,out).  ``mode="nearest"`` for depth maps
    (json_index_dataset.py:587 resizes depth with mode="nearest")."""
    from PIL import Image

    resample = Image.NEAREST if mode == "nearest" else Image.BILINEAR
    h, w = img.shape[:2]
    scale = min(out_size / h, out_size / w)
    nh, nw = int(h * scale), int(w * scale)
    chans = [np.asarray(Image.fromarray(
        np.ascontiguousarray(img[..., c])).resize((nw, nh), resample))
        for c in range(img.shape[-1])]
    small = np.stack(chans, axis=-1).astype(np.float32)
    out = np.zeros((out_size, out_size, img.shape[-1]), np.float32)
    out[:nh, :nw] = small
    valid = np.zeros((out_size, out_size), np.float32)
    valid[:nh, :nw] = 1.0
    return out, scale, valid


# ---------------------------------------------------------------------------
# depth maps + sequence point clouds (JsonIndexDataset extras)
# ---------------------------------------------------------------------------

def load_depth_png(path: str, scale_adjustment: float = 1.0) -> np.ndarray:
    """CO3D 16-bit depth PNG: the uint16 payload is a reinterpreted float16
    (json_index_dataset.py:925-956 _load_16big_png_depth/_load_depth).
    Returns (H, W) float32 with non-finite values zeroed."""
    from PIL import Image

    with Image.open(path) as pil:
        d = (np.array(pil, dtype=np.uint16).view(np.float16)
             .astype(np.float32).reshape(pil.size[1], pil.size[0]))
    d = d * float(scale_adjustment)
    d[~np.isfinite(d)] = 0.0
    return d


def save_depth_png(path: str, depth: np.ndarray) -> None:
    """Inverse of load_depth_png — float32 (H, W) -> CO3D 16-bit PNG
    (float16 bits stored as uint16).  Used by fixtures/exporters."""
    from PIL import Image

    bits = depth.astype(np.float16).view(np.uint16)
    Image.fromarray(bits).save(path)   # uint16 -> mode I;16


def load_depth_mask_png(path: str) -> np.ndarray:
    """1-bit depth-validity mask denoting depth values consistent across
    views (json_index_dataset.py:937-946).  Returns (H, W) float32 {0,1}."""
    from PIL import Image

    with Image.open(path) as pil:
        return (np.asarray(pil.convert("L"), np.float32) > 0).astype(np.float32)


def rescale_bbox(bbox_xyxy, orig_hw: Tuple[int, int],
                 new_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """Scale an xyxy box from one image resolution to another (pytorch3d
    _rescale_bbox — depth maps may be stored at a different resolution)."""
    sy = new_hw[0] / orig_hw[0]
    sx = new_hw[1] / orig_hw[1]
    x0, y0, x1, y1 = bbox_xyxy
    return int(x0 * sx), int(y0 * sy), int(x1 * sx), int(y1 * sy)


def load_pointcloud_ply(path: str, max_points: int = 0,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Sequence-level colored point cloud (json_index_dataset.py:1075-1083
    _load_pointcloud; pytorch3d IO ply).  Supports binary-LE and ascii
    vertex elements with float xyz + uchar or float rgb.  ``max_points>0``
    subsamples uniformly at random (Pointclouds.subsample)."""
    with open(path, "rb") as f:
        header: List[str] = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        n = 0
        props: List[Tuple[str, str]] = []   # (dtype, name) of vertex props
        in_vertex = False
        for ln in header:
            if ln.startswith("element"):
                in_vertex = ln.split()[1] == "vertex"
                if in_vertex:
                    n = int(ln.split()[2])
            elif ln.startswith("property") and in_vertex:
                _, typ, name = ln.split()
                props.append((typ, name))
        np_types = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}
        if fmt.startswith("binary"):
            order = "<" if "little" in fmt else ">"
            dt = np.dtype([(name, order + np_types[typ])
                           for typ, name in props])
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
        else:
            rows = [f.readline().split() for _ in range(n)]
            rec = {name: np.asarray([r[i] for r in rows], np_types[typ])
                   for i, (typ, name) in enumerate(props)}
    xyz = np.stack([np.asarray(rec[k], np.float32)
                    for k in ("x", "y", "z")], axis=-1)
    names = [name for _, name in props]
    if all(k in names for k in ("red", "green", "blue")):
        col = np.stack([np.asarray(rec[k], np.float32)
                        for k in ("red", "green", "blue")], axis=-1)
        typ = dict((nm, t) for t, nm in props)["red"]
        if typ in ("uchar", "uint8"):
            col = col / 255.0
    else:
        col = np.ones_like(xyz)
    if 0 < max_points < len(xyz):
        pick = np.random.RandomState(seed).permutation(len(xyz))[:max_points]
        xyz, col = xyz[pick], col[pick]
    return {"points": xyz, "colors": col}


# ---------------------------------------------------------------------------
# camera conversions (pytorch3d NDC -> OpenCV -> OpenGL 25-dim)
# ---------------------------------------------------------------------------

def ndc_to_screen(viewpoint: Dict, image_hw: Tuple[int, int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """NDC focal/principal-point -> pixels in the ORIGINAL image."""
    h, w = image_hw
    f = np.asarray(viewpoint["focal_length"], np.float64)
    p = np.asarray(viewpoint["principal_point"], np.float64)
    half_wh = np.asarray([w / 2.0, h / 2.0])
    fmt = viewpoint.get("intrinsics_format", "ndc_norm_image_bounds")
    if fmt == "ndc_isotropic":
        rescale = np.full(2, min(h, w) / 2.0)
    else:
        rescale = half_wh
    focal_px = f * rescale
    pp_px = half_wh - p * rescale
    return focal_px, pp_px


def screen_to_opencv_camera(viewpoint: Dict, focal_px: np.ndarray,
                            pp_px: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pytorch3d (R,T) -> OpenCV world-to-cam R, tvec, K
    (pytorch3d opencv_from_cameras_projection)."""
    R = np.asarray(viewpoint["R"], np.float64).copy()
    T = np.asarray(viewpoint["T"], np.float64).copy()
    R[:, :2] *= -1
    T[:2] *= -1
    R_cv = R.T
    K = np.asarray([[focal_px[0], 0, pp_px[0]],
                    [0, focal_px[1], pp_px[1]],
                    [0, 0, 1.0]])
    return R_cv, T, K


def opencv_to_pixelnerf_camera(R_cv: np.ndarray, tvec: np.ndarray,
                               K: np.ndarray, norm: float = 256.0) -> np.ndarray:
    """w2c (R,t) -> homogeneous c2w with y/z columns flipped (OpenGL), K
    rows/256; 25-dim (co3d.py:644-668)."""
    w2c = np.eye(4)
    w2c[:3, :3] = R_cv
    w2c[:3, 3] = tvec
    c2w = np.linalg.inv(w2c)
    c2w[:, 1:3] *= -1
    Kn = np.asarray(K, np.float64).copy()
    Kn[:2] /= norm
    return np.concatenate([c2w.reshape(16), Kn.reshape(9)]).astype(np.float32)


class Co3dDataset:
    """Sequence-level CO3Dv2 loader producing V3D training items."""

    def __init__(self, root_dir: str, category: str = "hydrant",
                 subset: str = "fewview_train", stage: str = "train",
                 sample_batch_size: int = 20, num_frames: int = 20,
                 reso: int = 256, box_crop: bool = True,
                 box_crop_thr: float = 0.4, box_crop_context: float = 0.3,
                 cond_aug_mean: float = -3.0, cond_aug_std: float = 0.5,
                 fps_id: float = 0.0, motion_bucket_id: float = 300.0,
                 load_pixelnerf: bool = True, scale_pose: bool = True,
                 masked: bool = False, min_seq_frames: int = 10,
                 max_n_cond: int = 1, min_n_cond: int = 1, seed: int = 0,
                 load_depths: bool = False, load_depth_masks: bool = False,
                 mask_depths: bool = False, load_point_clouds: bool = False,
                 max_points: int = 0, eval_batches=None,
                 eval_batch_index=None):
        self.root = root_dir
        self.reso = reso
        self.stage = stage
        self.subset = subset
        self.sample_batch_size = sample_batch_size
        self.num_frames = num_frames
        self.box_crop = box_crop
        self.box_crop_thr = box_crop_thr
        self.box_crop_context = box_crop_context
        self.cond_aug_mean = cond_aug_mean
        self.cond_aug_std = cond_aug_std
        self.fps_id = fps_id
        self.motion_bucket_id = motion_bucket_id
        self.load_pixelnerf = load_pixelnerf
        self.scale_pose = scale_pose
        self.masked = masked
        self.max_n_cond = max_n_cond
        self.min_n_cond = min_n_cond
        self.load_depths = load_depths
        self.load_depth_masks = load_depth_masks
        self.mask_depths = mask_depths
        self.load_point_clouds = load_point_clouds
        self.max_points = max_points
        self.rng = np.random.RandomState(seed)

        cats = [category] if isinstance(category, str) else list(category)
        frames: List[Dict] = []
        allowed: set = set()
        self.seq_annots: Dict[str, Dict] = {}
        for cat in cats:
            frames += load_jgz(os.path.join(root_dir, cat,
                                            "frame_annotations.jgz"))
            for sa in load_jgz(os.path.join(root_dir, cat,
                                            "sequence_annotations.jgz")):
                self.seq_annots[sa["sequence_name"]] = sa
            setlist = json.load(open(os.path.join(
                root_dir, cat, "set_lists", f"set_lists_{subset}.json")))
            for seq, fnum, _path in setlist[stage]:
                allowed.add((seq, fnum))

        self.frames = [f for f in frames
                       if (f["sequence_name"], f["frame_number"]) in allowed]
        seq_to_frames: Dict[str, List[int]] = {}
        for i, f in enumerate(self.frames):
            seq_to_frames.setdefault(f["sequence_name"], []).append(i)
        # short sequences dropped for training (co3d.py:497-505)
        if not (stage == "test" and subset == "fewview_test"):
            seq_to_frames = {s: ix for s, ix in seq_to_frames.items()
                             if len(ix) > min_seq_frames}
        for bad in REMOVE_SEQUENCES:
            seq_to_frames.pop(bad, None)
        self.seq_to_frames = seq_to_frames
        self.seq_list = sorted(seq_to_frames.keys())

        # eval batches (json_index_dataset.py:163-190): either given as
        # frame indices directly, or resolved from (seq, frame_number[,
        # path]) tuples via seq_frame_index_to_dataset_index.
        if eval_batch_index is not None and eval_batches is not None:
            raise ValueError(
                "Cannot define both eval_batch_index and eval_batches.")
        self.eval_batches = eval_batches
        if eval_batch_index is not None:
            self.eval_batches = self.seq_frame_index_to_dataset_index(
                eval_batch_index, allow_missing_indices=True,
                remove_missing_indices=True)
        self._pcl_cache: Dict[str, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.seq_list)

    # -- frame-level index surface (JsonIndexDataset analog) ----------------

    def seq_frame_index_to_dataset_index(
            self, seq_frame_index: Sequence[Sequence],
            allow_missing_indices: bool = False,
            remove_missing_indices: bool = False) -> List[List[Optional[int]]]:
        """Resolve batches of (sequence_name, frame_number[, image_path])
        tuples to frame indices (json_index_dataset.py:248-330).  Missing
        entries raise IndexError, or become None / are dropped depending on
        the two flags."""
        by_seq_frame: Dict[Tuple[str, int], int] = {
            (f["sequence_name"], f["frame_number"]): i
            for i, f in enumerate(self.frames)}

        def _one(entry) -> Optional[int]:
            seq, fnum = entry[0], entry[1]
            idx = by_seq_frame.get((seq, int(fnum)))
            if idx is None:
                if not allow_missing_indices:
                    raise IndexError(
                        f"sequence_name={seq} / frame_number={fnum}"
                        " not in the dataset!")
                return None
            if len(entry) > 2 and entry[2]:
                stored = os.path.normpath(self.frames[idx]["image"]["path"])
                if stored != os.path.normpath(entry[2]):
                    raise ValueError(
                        f"inconsistent image path for {seq}/{fnum}: "
                        f"{stored} != {entry[2]}")
            return idx

        out = [[_one(e) for e in batch] for batch in seq_frame_index]
        if remove_missing_indices:
            out = [[i for i in batch if i is not None] for batch in out]
        return out

    def _sequence_point_cloud(self, seq: str) -> Optional[Dict[str, np.ndarray]]:
        """Sequence point cloud, lru-style cached per dataset
        (json_index_dataset.py:1070-1083)."""
        if seq in self._pcl_cache:
            return self._pcl_cache[seq]
        ann = self.seq_annots.get(seq, {})
        pc = ann.get("point_cloud")
        if not pc:
            return None
        pcl = load_pointcloud_ply(os.path.join(self.root, pc["path"]),
                                  max_points=self.max_points)
        self._pcl_cache[seq] = pcl
        return pcl

    def frame_data(self, index: int) -> Dict:
        """Per-frame record mirroring pytorch3d FrameData
        (json_index_dataset.py:414-485): image/fg/camera plus the optional
        depth map, depth mask, and sequence point cloud."""
        ann = self.frames[index]
        seq = ann["sequence_name"]
        seq_ann = self.seq_annots.get(seq, {})
        out = self._load_frame(ann)
        out.update(
            frame_number=int(ann["frame_number"]),
            sequence_name=seq,
            sequence_category=seq_ann.get("category"),
            camera_quality_score=seq_ann.get("viewpoint_quality_score"),
            point_cloud_quality_score=(
                seq_ann.get("point_cloud", {}) or {}).get("quality_score"),
        )
        if self.load_point_clouds:
            out["sequence_point_cloud"] = self._sequence_point_cloud(seq)
        return out

    # -- single frame -------------------------------------------------------

    def _load_frame(self, ann: Dict) -> Dict:
        from PIL import Image

        img = np.asarray(Image.open(
            os.path.join(self.root, ann["image"]["path"])).convert("RGB"),
            np.float32) / 255.0
        mask = np.asarray(Image.open(
            os.path.join(self.root, ann["mask"]["path"])).convert("L"),
            np.float32) / 255.0
        h, w = img.shape[:2]
        focal_px, pp_px = ndc_to_screen(ann["viewpoint"], (h, w))

        depth = depth_mask = None
        if self.load_depths and ann.get("depth"):
            depth = load_depth_png(
                os.path.join(self.root, ann["depth"]["path"]),
                ann["depth"].get("scale_adjustment", 1.0))
            if self.load_depth_masks and ann["depth"].get("mask_path"):
                depth_mask = load_depth_mask_png(
                    os.path.join(self.root, ann["depth"]["mask_path"]))

        if self.box_crop:
            bbox = get_bbox_from_mask(mask, self.box_crop_thr)
            x0, y0, x1, y1 = clamp_bbox(bbox, self.box_crop_context, h, w)
            img = img[y0:y1, x0:x1]
            mask = mask[y0:y1, x0:x1]
            pp_px = pp_px - np.asarray([x0, y0], np.float64)
            if depth is not None:
                dx0, dy0, dx1, dy1 = rescale_bbox(
                    (x0, y0, x1, y1), (h, w), depth.shape)
                depth = depth[dy0:dy1, dx0:dx1]
            if depth_mask is not None:
                mx0, my0, mx1, my1 = rescale_bbox(
                    (x0, y0, x1, y1), (h, w), depth_mask.shape)
                depth_mask = depth_mask[my0:my1, mx0:mx1]

        img, scale, valid = resize_longest(img, self.reso)
        mask = resize_longest(mask[..., None], self.reso)[0][..., 0]
        focal_px = focal_px * scale
        pp_px = pp_px * scale

        R_cv, tvec, K = screen_to_opencv_camera(
            ann["viewpoint"], focal_px, pp_px)
        out = {"rgb": img, "fg": mask, "valid": valid,
               "R": R_cv, "t": tvec, "K": K,
               "timestamp": ann.get("frame_timestamp", 0.0)}
        if depth is not None:
            depth = resize_longest(depth[..., None], self.reso,
                                   mode="nearest")[0][..., 0]
            if self.mask_depths:
                depth = depth * mask
            out["depth_map"] = depth
            out["depth_mask"] = (
                resize_longest(depth_mask[..., None], self.reso,
                               mode="nearest")[0][..., 0]
                if depth_mask is not None else np.ones_like(depth))
        return out

    # -- item ---------------------------------------------------------------

    def _mirror_pad(self, arr: np.ndarray) -> np.ndarray:
        """cat([x, flip(x)])[:num_frames] (co3d.py:590-594)."""
        if len(arr) >= self.num_frames:
            return arr[:self.num_frames]
        return np.concatenate([arr, arr[::-1]], axis=0)[:self.num_frames]

    def __getitem__(self, index: int) -> Dict:
        seq = self.seq_list[index]
        idxs = self.seq_to_frames[seq]
        if self.stage == "test":
            pick = np.linspace(0, len(idxs) - 1,
                               self.sample_batch_size).astype(int)
        else:
            pick = self.rng.permutation(len(idxs))[:self.sample_batch_size]
        frames = [self._load_frame(self.frames[idxs[i]]) for i in pick]
        frames.sort(key=lambda f: f["timestamp"])

        rgb = np.stack([f["rgb"] for f in frames])
        fg = np.stack([f["fg"] for f in frames])[..., None]
        composited = rgb * fg + (1 - fg)       # white bg (co3d.py:571-572)
        images = composited if self.masked else rgb
        images = self._mirror_pad(images)
        fg = self._mirror_pad(fg)
        t = self.num_frames

        data: Dict = {}
        frames_pm1 = images * 2.0 - 1.0
        cond = frames_pm1[0]
        cond_aug = float(np.exp(
            self.rng.randn() * self.cond_aug_std + self.cond_aug_mean))
        data["frames"] = frames_pm1.astype(np.float32)
        data["masks"] = fg.astype(np.float32)
        data["cond_frames_without_noise"] = cond
        data["cond_frames"] = (
            cond + cond_aug * self.rng.randn(*cond.shape).astype(np.float32))
        data["cond_aug"] = np.full((t,), cond_aug, np.float32)
        data["fps_id"] = np.full((t,), self.fps_id, np.float32)
        data["motion_bucket_id"] = np.full((t,), self.motion_bucket_id,
                                           np.float32)
        data["num_video_frames"] = t
        data["image_only_indicator"] = np.zeros((t,), np.float32)

        if self.load_pixelnerf:
            cams = np.stack([opencv_to_pixelnerf_camera(
                f["R"], f["t"], f["K"], norm=self.reso) for f in frames])
            cams = self._mirror_pad(cams)
            if self.scale_pose:
                cams = normalize_poses(cams)
            small = np.stack([resize_longest(im, self.reso // 8)[0]
                              for im in images])
            data["pixelnerf_input"] = {
                "frames": data["frames"],
                "cameras": cams.astype(np.float32),
                "rgb": small.astype(np.float32),
            }
        return data

    def collate_fn(self, items: Sequence[Dict]) -> Dict:
        if self.max_n_cond > 1:
            n_cond = int(self.rng.randint(self.min_n_cond,
                                          self.max_n_cond + 1))
            if n_cond > 1:
                for it in items:
                    src = [0] + self.rng.choice(
                        np.arange(1, self.num_frames), self.max_n_cond - 1,
                        replace=False).tolist()
                    pn = it["pixelnerf_input"]
                    pn["source_index"] = np.asarray(src, np.int32)
                    pn["n_cond"] = n_cond
                    pn["source_images"] = it["frames"][src]
                    pn["source_cameras"] = pn["cameras"][src]
        return video_collate(items)

    def iter_batches(self, batch_size: int) -> Iterator[Dict]:
        while True:
            idx = self.rng.randint(0, len(self), batch_size)
            yield self.collate_fn([self[int(i)] for i in idx])
