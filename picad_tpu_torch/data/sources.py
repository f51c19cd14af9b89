"""Video sources: decode + annotation rasterization.

The port's copy of picad_tpu/data/sources.py (numpy, with OpenCV and
scipy imported lazily inside the decoders, so importing this module
needs neither): the same records, pixels and annotation draws.

A VideoSource yields whole annotated videos; clip sampling happens in
dataset.py.  Three backends:

- `UCFVideoSource`: UCF101-24 — pickled annotation lists
  [(video_name, [ann, ...]), ...] with ann = (start_frame, end_frame,
  label, boxes, keyframe_ids, labeled_flag), videos decoded from
  `<root>/UCF101_Videos/<name>.avi`; per-frame box rasterization matches
  datasets/ucf_dataloader.py:203-264 (union over all annotations; the
  keyframe-interpolated variant of :237-258 is `rasterize_keyframe_boxes`,
  used by the eval 'train' split like ucf_dataloader_eval.py returns
  bbox_annot).
- `JHMDBVideoSource`: JHMDB-21 — txt video lists, cv2 decode in the
  reference's raw BGR order (its loaders never cvtColor), resized to
  256x256 INTER_AREA for training / kept raw for eval, `puppet_mask.mat`
  part_mask volumes resized NEAREST (train) or raw (eval)
  (datasets/jhmdb_dataloader.py:233-307, jhmdb_dataloader_eval.py:83-140);
  every frame is annotated.
- `SyntheticVideoSource`: procedural moving-actor videos + exact
  rectangular masks, deterministic per (seed, index) — the hermetic
  backend for tests and benchmarks (the reference has no equivalent; its
  decode failures degrade to zero samples, which we also replicate).

Decode failures return `None`, which the dataset converts into an
all-zero sample flagged unlabeled, replicating
datasets/ucf_dataloader.py:96-121,199-201.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

JHMDB_CLASSES = (
    "brush_hair", "catch", "clap", "climb_stairs", "golf", "jump",
    "kick_ball", "pick", "pour", "pullup", "push", "run", "shoot_ball",
    "shoot_bow", "shoot_gun", "sit", "stand", "swing_baseball", "throw",
    "walk", "wave",
)


@dataclasses.dataclass
class VideoRecord:
    """One decoded, annotated video."""

    video: np.ndarray  # (F, H, W, 3) uint8 or float
    mask: np.ndarray  # (F, H, W, 1) uint8
    label: int
    annot_frames: np.ndarray  # frame ids that carry annotation
    labeled: int  # 1 = labeled subset, 0 = unlabeled
    name: str = ""  # video identifier (for eval logging)


def rasterize_boxes(
    n_frames: int, h: int, w: int, annotations: Sequence
) -> tuple[np.ndarray, int, int, list[int]]:
    """Union-of-boxes per-frame heat map over all annotation tracks.

    Matches datasets/ucf_dataloader.py:203-229 (the per-frame `bbox`
    volume): for each ann = (start, end, label, boxes, keyframes, labeled)
    and each covered frame, paint box (x, y, w, h) with 1.
    Returns (mask (F, H, W, 1), label, labeled_flag, keyframes-union).
    """
    mask = np.zeros((n_frames, h, w, 1), dtype=np.uint8)
    label, labeled = -1, -1
    keyframes: list[int] = []
    for ann in annotations:
        start_frame, end_frame, label = int(ann[0]), int(ann[1]), int(ann[2])
        labeled = int(ann[5]) if len(ann) > 5 else 1
        keyframes.extend(int(f) for f in ann[4])
        boxes = ann[3]
        for f in range(start_frame, min(n_frames, end_frame + 1)):
            x, y, bw, bh = (int(v) for v in boxes[f - start_frame])
            mask[f, y : y + bh, x : x + bw, :] = 1
    return mask, label, labeled, sorted(set(keyframes))


def rasterize_keyframe_boxes(
    n_frames: int, h: int, w: int, ann
) -> np.ndarray:
    """Keyframe boxes linearly interpolated between annotated frames.

    Matches the bbox_annot construction (datasets/ucf_dataloader.py:230-258
    / ucf_dataloader_eval.py train branch): boxes at the sorted keyframes
    are connected by np.linspace over (x1, y1, x2, y2) corners.
    """
    mask = np.zeros((n_frames, h, w, 1), dtype=np.uint8)
    start_frame, end_frame = int(ann[0]), int(ann[1])
    boxes, keyframes = ann[3], sorted(int(f) for f in ann[4])
    collect = []
    for f in keyframes:
        idx = f - start_frame
        if 0 <= idx < len(boxes) and f < n_frames:
            collect.append([int(v) for v in boxes[idx]])
    if not collect:
        return mask
    if len(collect) == 1:
        x, y, bw, bh = collect[0]
        mask[start_frame:end_frame, y : y + bh, x : x + bw, :] = 1
        return mask
    x, y, bw, bh = collect[0]
    mask[start_frame : keyframes[0], y : y + bh, x : x + bw, :] = 1
    for i in range(len(collect) - 1):
        frame_diff = keyframes[i + 1] - keyframes[i]
        if frame_diff > 1:
            x, y, bw, bh = collect[i]
            pt1 = np.array([x, y, x + bw, y + bh])
            x, y, bw, bh = collect[i + 1]
            pt2 = np.array([x, y, x + bw, y + bh])
            points = np.linspace(pt1, pt2, frame_diff).astype(np.int32)
            for j in range(points.shape[0]):
                x1, y1, x2, y2 = points[j]
                mask[keyframes[i] + j, y1:y2, x1:x2, :] = 1
        else:
            x, y, bw, bh = collect[i]
            mask[keyframes[i], y : y + bh, x : x + bw, :] = 1
    x, y, bw, bh = collect[-1]
    mask[keyframes[-1] : end_frame, y : y + bh, x : x + bw, :] = 1
    return mask


def _decode_video(path: str, *, to_rgb: bool = True) -> np.ndarray | None:
    """Decode a whole video with OpenCV.

    cv2 yields BGR frames; `to_rgb=True` converts to RGB (what
    skvideo.io.vread produces, so the UCF path matches the reference's
    decode library output order).  `to_rgb=False` keeps raw BGR — the
    reference's JHMDB loaders append cv2 frames with no conversion
    (jhmdb_dataloader.py:238-246, jhmdb_dataloader_eval.py:108-118), so
    every reference JHMDB checkpoint sees BGR input.
    """
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1] if to_rgb else frame)
        cap.release()
        if not frames:
            return None
        return np.stack(frames)
    except Exception:
        return None


def _decode_video_skvideo(path: str) -> np.ndarray | None:
    """Decode with skvideo.io.vread (ffmpeg) — the reference's UCF decode
    library (ucf_dataloader.py:197, ucf_dataloader_eval.py:116).  Returns
    RGB (F, H, W, 3) uint8.  Requires the optional `scikit-video` package
    plus an ffmpeg binary; callers gate on availability."""
    try:
        from skvideo.io import vread  # optional dependency
    except ImportError as e:
        raise ImportError(
            "decoder='skvideo' needs the scikit-video package (and ffmpeg); "
            "install it or use the default decoder='cv2'"
        ) from e
    try:
        return np.asarray(vread(str(path)))
    except Exception:
        return None


def _decode_with_npy_cache(
    path: str, cache_dir: str | None, key: str, *, decoder: str = "cv2"
) -> np.ndarray | None:
    """Whole-video decode with a write-through pre-decoded .npy cache.

    The reference decodes the ENTIRE .avi for every clip sample
    (ucf_dataloader.py:197) — the wall-clock bound at 5x device speedup
    (SURVEY §7 hard part 4).  With `cache_dir` set, the first touch of a
    video decodes it once and writes `<cache_dir>/<key>.npy` (uint8);
    every later touch memory-maps the file, so a clip sample reads only
    the ~8 needed frames from the page cache instead of running ffmpeg
    over hundreds.
    """
    decode = _decode_video if decoder == "cv2" else _decode_video_skvideo
    if cache_dir is None:
        return decode(path)
    # decoded pixels can differ between decode stacks (swscale versions,
    # color-range handling), so skvideo-decoded files get their own key
    npy = os.path.join(
        cache_dir, f"{key}.npy" if decoder == "cv2" else f"{key}.skv.npy"
    )
    if os.path.exists(npy):
        try:
            return np.load(npy, mmap_mode="r")
        except Exception:
            pass  # corrupt/partial file: fall through to re-decode
    video = decode(path)
    if video is None:
        return None
    try:
        os.makedirs(os.path.dirname(npy), exist_ok=True)
        tmp = f"{npy}.tmp.{os.getpid()}.{threading.get_ident()}"
        np.save(tmp, video)
        os.replace(tmp, npy)  # atomic: concurrent workers race safely
    except Exception:
        pass  # cache is best-effort; decode result is still valid
    return video


class ConcatVideoSource:
    """Concatenation of several VideoSources under one index space.

    Used by the device video cache to pool the labeled + unlabeled
    streams' frames into ONE HBM-resident pool (device_cache.py);
    per-stream datasets then view contiguous index windows."""

    def __init__(self, sources: Sequence):
        self.sources = list(sources)
        self._bounds = np.cumsum([0] + [len(s) for s in self.sources])

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def set_epoch(self, epoch: int) -> None:
        for s in self.sources:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def load(self, index: int):
        k = int(np.searchsorted(self._bounds, index, side="right")) - 1
        return self.sources[k].load(index - int(self._bounds[k]))


class CachedVideoSource:
    """Thread-safe in-memory LRU over any VideoSource's decoded records.

    The labeled stream is cycled several times per epoch
    (main_ucf101.py:173-178), so the same video is decoded repeatedly;
    an LRU with a byte budget eliminates those repeat decodes.  Safe
    under the loader's thread pool.
    """

    def __init__(self, source, capacity_bytes: int = 4 << 30):
        self.source = source
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        self._cache: "OrderedDict[int, VideoRecord | None]" = OrderedDict()
        self._bytes = 0

    def __len__(self) -> int:
        return len(self.source)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    @staticmethod
    def _size(rec: "VideoRecord | None") -> int:
        if rec is None:
            return 64
        # Memmapped videos cost ~no RSS, but each holds an open file
        # descriptor — charge a nominal 1 MiB so the LRU's byte budget
        # also bounds the open-fd count (budget/1MiB entries max)
        # instead of retaining unboundedly many mask-only records.
        vid = (
            1 << 20 if isinstance(rec.video, np.memmap) else rec.video.nbytes
        )
        return vid + rec.mask.nbytes

    def load(self, index: int) -> "VideoRecord | None":
        with self._lock:
            if index in self._cache:
                self._cache.move_to_end(index)
                return self._cache[index]
        rec = self.source.load(index)
        size = self._size(rec)
        if size > self.capacity:
            return rec
        with self._lock:
            if index not in self._cache:
                self._cache[index] = rec
                self._bytes += size
                while self._bytes > self.capacity and len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._bytes -= self._size(old)
        return rec


class UCFVideoSource:
    """UCF101-24 source over a pickled annotation list."""

    def __init__(
        self,
        annotation_file: str,
        data_root: str,
        *,
        single_annotation: bool = False,
        keyframe_masks: bool = False,
        annotation_seed: int = 47,
        decoded_cache_dir: str | None = None,
        decoder: str = "cv2",
    ):
        with open(annotation_file, "rb") as f:
            self.records = pickle.load(f)
        self.data_root = data_root
        self.single_annotation = single_annotation
        self.decoded_cache_dir = decoded_cache_dir
        if decoder not in ("cv2", "skvideo"):
            raise ValueError(f"unknown decoder {decoder!r}")
        # 'skvideo' reproduces the reference's UCF decode library
        # (skvideo.io.vread, ucf_dataloader.py:197); 'cv2' (default) is
        # the built-in stack — pixels are usually identical but the two
        # ffmpeg paths are not provably so (see PARITY.md).
        self.decoder = decoder
        # 'train'-split eval masks: keyframe boxes linearly interpolated
        # (ucf_dataloader_eval.py returns bbox_annot for name == 'train')
        self.keyframe_masks = keyframe_masks
        # Per-video single-annotation choice, precomputed in DATASET ORDER
        # from the legacy MT19937 stream — exactly the draws the reference
        # makes with np.random.seed(47) (evaluate_ucf101.py:36) +
        # np.random.randint(0, len) only when len > 1
        # (ucf_dataloader_eval.py:135-137), iterated index 0..N-1 (the
        # num_workers=0 semantics; with workers the reference's stream is
        # torch-version-dependent — PARITY.md).  Precomputing makes the
        # choice independent of prefetch access order.
        if single_annotation:
            rs = np.random.RandomState(annotation_seed)
            self._annot_choice = [
                int(rs.randint(0, len(anns))) if len(anns) > 1 else 0
                for _v_name, anns in self.records
            ]
        else:
            self._annot_choice = None

    def __len__(self) -> int:
        return len(self.records)

    def load(self, index: int) -> VideoRecord | None:
        v_name, anns = self.records[index]
        video = _decode_with_npy_cache(
            os.path.join(self.data_root, "UCF101_Videos", f"{v_name}.avi"),
            self.decoded_cache_dir,
            v_name,
            decoder=self.decoder,
        )
        if video is None:
            return None
        n, h, w, _ = video.shape
        if self.single_annotation:
            anns = [anns[self._annot_choice[index]]]
        mask, label, labeled, keyframes = rasterize_boxes(n, h, w, anns)
        if self.keyframe_masks:
            mask = rasterize_keyframe_boxes(n, h, w, anns[0])
        return VideoRecord(
            video, mask, label, np.asarray(keyframes), labeled, name=v_name
        )


class JHMDBVideoSource:
    """JHMDB-21 source over a txt video list + puppet masks.

    `channel_order`:
    - 'reference' (default): raw cv2 BGR frames, exactly what the
      reference feeds — its JHMDB loaders never convert
      (jhmdb_dataloader.py:238-246, jhmdb_dataloader_eval.py:108-118),
      so every reference JHMDB checkpoint was trained AND evaluated on
      BGR input.  Use this for any run that must be comparable to, or
      load, reference weights.
    - 'rgb': converted frames, for training fresh checkpoints whose
      I3D pretrain (rgb_charades.pt) saw RGB.

    `resize`:
    - 256 (default): frames INTER_AREA-resized + masks INTER_NEAREST to
      256x256 — the TRAIN loader's geometry (jhmdb_dataloader.py:249-268).
    - None: raw-resolution frames and UNRESIZED puppet masks — the EVAL
      loader's geometry (jhmdb_dataloader_eval.py:83-140 center-crops the
      raw 240x320 video and transposes the raw mask volume; it never
      resizes to 256).  Eval at 256 would crop different pixels and score
      against resampled ground truth — not the reference protocol.
    """

    def __init__(
        self,
        list_file: str,
        data_root: str,
        mask_root: str,
        decoded_cache_dir: str | None = None,
        *,
        channel_order: str = "reference",
        resize: int | None = 256,
    ):
        with open(list_file) as f:
            self.names = [line.strip() for line in f if line.strip()]
        self.data_root = data_root
        self.mask_root = mask_root
        self.decoded_cache_dir = decoded_cache_dir
        if channel_order not in ("reference", "rgb"):
            raise ValueError(f"unknown channel_order {channel_order!r}")
        self.channel_order = channel_order
        self.resize = resize

    def __len__(self) -> int:
        return len(self.names)

    def _cache_key(self, name: str) -> str:
        # Distinct keys per (channel order, geometry): 'reference' BGR and
        # raw-resolution variants must never read a cache file written by
        # the other combination.
        order = "bgr" if self.channel_order == "reference" else "rgb"
        geom = f"r{self.resize}" if self.resize else "raw"
        return f"{name}.{order}.{geom}"

    def _decode_resized(self, name: str) -> np.ndarray | None:
        """Decode (+ optional INTER_AREA resize) with the .npy
        write-through cache; the resize happens before caching, so cache
        hits skip both the decode and the resize."""
        import cv2

        if self.decoded_cache_dir is not None:
            npy = os.path.join(
                self.decoded_cache_dir, f"{self._cache_key(name)}.npy"
            )
            if os.path.exists(npy):
                try:
                    return np.load(npy, mmap_mode="r")
                except Exception:
                    pass
        video = _decode_video(
            os.path.join(self.data_root, f"{name}.avi"),
            to_rgb=self.channel_order == "rgb",
        )
        if video is None:
            return None
        if self.resize:
            video = np.stack(
                [
                    cv2.resize(
                        f, (self.resize, self.resize),
                        interpolation=cv2.INTER_AREA,
                    )
                    for f in video
                ]
            )
        else:
            video = np.ascontiguousarray(video)
        if self.decoded_cache_dir is not None:
            try:
                os.makedirs(os.path.dirname(npy), exist_ok=True)
                tmp = f"{npy}.tmp.{os.getpid()}.{threading.get_ident()}"
                np.save(tmp, video)
                os.replace(tmp, npy)
            except Exception:
                pass
        return video

    def load(self, index: int) -> VideoRecord | None:
        import cv2
        from scipy.io import loadmat

        name = self.names[index]
        vid = self._decode_resized(name)
        if vid is None:
            return None
        try:
            mat = loadmat(os.path.join(self.mask_root, name, "puppet_mask.mat"))
            part_mask = mat["part_mask"]  # (H, W, F)
        except Exception:
            return None
        n_mask = part_mask.shape[2]
        if self.resize:
            # masks NEAREST to 256x256, like jhmdb_dataloader.py:257-268
            mask = np.stack(
                [
                    cv2.resize(
                        part_mask[:, :, m], (self.resize, self.resize),
                        interpolation=cv2.INTER_NEAREST,
                    )
                    for m in range(n_mask)
                ]
            )[..., None].astype(np.uint8)
        else:
            # eval geometry: raw mask volume transposed (F, H, W, 1)
            # (jhmdb_dataloader_eval.py:136-138)
            mask = np.transpose(part_mask, (2, 0, 1))[..., None].astype(
                np.uint8
            )
        label = JHMDB_CLASSES.index(name.split("/")[0])
        annot_frames = np.arange(mask.shape[0])
        return VideoRecord(vid, mask, label, annot_frames, labeled=1, name=name)


class SyntheticVideoSource:
    """Procedural actor videos: a textured rectangle moving over noise.

    Deterministic per (seed, index).  Shapes mimic UCF101 (240x320).
    """

    def __init__(
        self,
        num_videos: int = 64,
        *,
        video_len: int = 40,
        height: int = 240,
        width: int = 320,
        num_classes: int = 24,
        labeled_fraction: float = 0.5,
        seed: int = 0,
    ):
        self.num_videos = num_videos
        self.video_len = video_len
        self.height = height
        self.width = width
        self.num_classes = num_classes
        self.labeled_fraction = labeled_fraction
        self.seed = seed

    def __len__(self) -> int:
        return self.num_videos

    def load(self, index: int) -> VideoRecord | None:
        rng = np.random.default_rng((self.seed, index))
        F, H, W = self.video_len, self.height, self.width
        video = rng.integers(0, 60, (F, H, W, 3), dtype=np.uint8)
        mask = np.zeros((F, H, W, 1), dtype=np.uint8)
        bh, bw = int(rng.integers(40, 90)), int(rng.integers(30, 70))
        y0 = int(rng.integers(0, H - bh))
        x0 = int(rng.integers(0, W - bw))
        vy, vx = rng.integers(-3, 4, 2)
        for f in range(F):
            y = int(np.clip(y0 + vy * f, 0, H - bh))
            x = int(np.clip(x0 + vx * f, 0, W - bw))
            video[f, y : y + bh, x : x + bw] = rng.integers(
                120, 255, (bh, bw, 3), dtype=np.uint8
            )
            mask[f, y : y + bh, x : x + bw] = 1
        label = int(rng.integers(0, self.num_classes))
        labeled = int(rng.uniform() < self.labeled_fraction)
        annot_frames = np.arange(2, F - 2, 4)
        return VideoRecord(
            video, mask, label, annot_frames, labeled, name=f"synthetic/{index}"
        )
