"""Card-resident decoded-video cache: clips assemble on the device.

Counterpart of picad_tpu/data/device_cache.py.  The streaming pipeline
copies every sampled clip to the card (12.8 MB of uint8 pixels and
masks per batch of 8 at 224^2).  Here the decoded videos live on the
card as one uint8 frame pool, and each train step ships only clip
METADATA (pool frame indices, crop origin, validity: ~100 bytes a
sample).  The assembler (`make_assembler_put`, run by PrefetchLoader on
its side stream) gathers the metadata batch into the streaming path's
uint8 pixel batch on the card, so the train step is the same either way.

Semantics are those of the streaming path: `DeviceClipDataset` reuses
`ClipDataset`'s sampling rules (the same rng stream, vskip/boundary and
zero-sample behaviour — datasets/ucf_dataloader.py:86-148) and
`assemble_batch` reproduces its crop + (mask > 0) & valid assembly bit
for bit.  The gather is one torch indexing op; the JAX package's is XLA
dynamic slices, whose clamping of the start indices is kept.

Capacity: the pool must fit `budget_bytes`, else `build` raises and the
caller keeps the streaming pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.data.dataset import ClipDataset
from picad_tpu_torch.data.sources import VideoRecord


class _ShapeOnly:
    """Stands in for a decoded video inside metadata-only VideoRecords."""

    def __init__(self, shape):
        self.shape = shape
        self.dtype = np.uint8


@dataclasses.dataclass
class _MetaSource:
    """Light host-side view of a cached source: shapes + annotations."""

    records: list  # VideoRecord with _ShapeOnly video, or None

    def __len__(self):
        return len(self.records)

    def load(self, index):
        return self.records[index]


class DeviceVideoCache:
    """A whole VideoSource in one device-resident frame pool.

    pool_video: (1 + sum(F_i), H, W, 3) uint8 — slot 0 is an all-zero
    frame that degraded samples and ragged-batch padding point at.
    pool_mask:  same leading dim, (H, W, 1) uint8 in {0, 1} (thresholded
    at upload: the host path's `mask > 0` happens once here).
    """

    def __init__(self, pool_video, pool_mask, offsets, meta_source, frame_hw):
        self.pool_video = pool_video
        self.pool_mask = pool_mask
        self.offsets = offsets  # per-video first-frame index into the pool
        self.meta_source = meta_source
        self.frame_hw = frame_hw

    @classmethod
    def build(cls, source, *, budget_bytes: int = 8 << 30, device=None):
        """Decode every video in `source` once and upload it to `device`
        (default: the CUDA card), one video at a time into pools
        allocated once on the device, so no upload holds more than one
        video's bytes twice.

        Raises ValueError if the pool would exceed `budget_bytes` (the
        caller then keeps the host streaming pipeline)."""
        dev = resolve_device(device)
        videos, masks, metas = [], [], []
        frame_hw = None
        total_frames = 1  # slot 0 reserved for the zero frame
        offsets = np.zeros((len(source),), np.int64)
        for i in range(len(source)):
            rec = source.load(i)
            if rec is None or rec.video.dtype != np.uint8:
                metas.append(None)
                continue
            f, h, w, _ = rec.video.shape
            if frame_hw is None:
                frame_hw = (h, w)
            elif frame_hw != (h, w):
                raise ValueError(
                    f"video {i} is {h}x{w}, pool is {frame_hw[0]}x{frame_hw[1]}"
                )
            offsets[i] = total_frames
            total_frames += f
            bytes_needed = total_frames * h * w * 4  # rgb + mask channel
            if bytes_needed > budget_bytes:
                raise ValueError(
                    f"device video cache needs >{bytes_needed >> 20} MiB "
                    f"(budget {budget_bytes >> 20} MiB) at video {i}/"
                    f"{len(source)} — keep the streaming pipeline"
                )
            videos.append(rec.video)
            masks.append((rec.mask.reshape(f, h, w, 1) > 0).astype(np.uint8))
            metas.append(
                VideoRecord(
                    video=_ShapeOnly((f, h, w, 3)),
                    mask=_ShapeOnly((f, h, w, 1)),
                    label=rec.label,
                    annot_frames=np.asarray(rec.annot_frames),
                    labeled=rec.labeled,
                    name=rec.name,
                )
            )
        if frame_hw is None:
            raise ValueError("no decodable videos in source")
        h, w = frame_hw
        pool_video = torch.empty((total_frames, h, w, 3), dtype=torch.uint8, device=dev)
        pool_mask = torch.empty((total_frames, h, w, 1), dtype=torch.uint8, device=dev)
        pool_video[0] = 0
        pool_mask[0] = 0
        start = 1
        for video, mask in zip(videos, masks):
            n = video.shape[0]
            pool_video[start:start + n].copy_(torch.from_numpy(np.ascontiguousarray(video)))
            pool_mask[start:start + n].copy_(torch.from_numpy(mask))
            start += n
        return cls(pool_video, pool_mask, offsets, _MetaSource(metas), frame_hw)


class DeviceClipDataset(ClipDataset):
    """ClipDataset over a DeviceVideoCache: yields clip METADATA samples.

    Sample layout (all tiny; ~100 bytes):
      frame_idx (depth,) int32 — absolute pool frame indices (0 = zero)
      crop_y / crop_x     int32 — crop origin
      valid (depth,) float32    — per-frame validity (JHMDB rule)
      action / label_vid  int32

    The pixel work happens in `assemble_batch` on the loader's side
    stream (make_assembler_put).  Sampling decisions (clip span, crop,
    degrade-to-zero) are IDENTICAL to the host ClipDataset: the same
    `_sample_plan`, the same per-(seed, epoch, index) rng stream.
    """

    def __init__(
        self,
        cache: DeviceVideoCache,
        *,
        index_offset: int = 0,
        length: int | None = None,
        **kwargs,
    ):
        """`index_offset`/`length` expose a contiguous window of the
        merged cache as its own dataset (e.g. labeled videos 0..n_l-1,
        unlabeled n_l..n_l+n_u-1 in one shared frame pool) while the rng
        stream stays keyed by the LOCAL index — same sampling decisions
        as separate host datasets over the separate sources."""
        kwargs.setdefault("device_prep", True)
        kwargs.setdefault("use_native", False)
        super().__init__(cache.meta_source, **kwargs)
        self.cache = cache
        self.index_offset = index_offset
        self.length = (
            length if length is not None else len(cache.meta_source) - index_offset
        )

    def __len__(self) -> int:
        return self.length

    @property
    def supports_fill(self) -> bool:
        return False  # samples are tiny dicts; the generic path is cheap

    def _zero_meta(self):
        return {
            "frame_idx": np.zeros((self.depth,), np.int32),
            "crop_y": np.int32(0),
            "crop_x": np.int32(0),
            "valid": np.zeros((self.depth,), np.float32),
            "action": np.int32(0),
            "label_vid": np.int32(0),
        }

    def zero_sample(self):
        """Degraded/padding sample in THIS dataset's metadata layout (a
        pixel-layout zero sample would not collate with the metadata
        samples __getitem__ yields)."""
        return self._zero_meta()

    def __getitem__(self, index: int):
        gidx = index + self.index_offset
        plan = self._sample_plan(index, source_index=gidx)
        if plan is None:
            return self._zero_meta()
        rec, span, y, x, valid = plan
        base = int(self.cache.offsets[gidx])
        return {
            "frame_idx": (base + span).astype(np.int32),
            "crop_y": np.int32(y),
            "crop_x": np.int32(x),
            "valid": valid.astype(np.float32),
            "action": np.int32(rec.label),
            "label_vid": np.int32(rec.labeled),
        }


def _gather_clips(pool_video, pool_mask, frame_idx, crop_y, crop_x, out_hw):
    """Crop-gather of (B, depth) frames at per-clip origins -> data
    (B, depth, ch, cw, 3) and mask (B, depth, ch, cw, 1), uint8.  The
    start indices are clamped into range, as XLA's dynamic_slice does."""
    ch, cw = out_hw
    F, H, W, _ = pool_video.shape
    dev = pool_video.device
    f = frame_idx.long().clamp(0, F - 1)[:, :, None, None]
    ys = crop_y.long().clamp(0, H - ch)[:, None, None, None] + torch.arange(
        ch, device=dev)[:, None]
    xs = crop_x.long().clamp(0, W - cw)[:, None, None, None] + torch.arange(cw, device=dev)
    return pool_video[f, ys, xs], pool_mask[f, ys, xs]


def assemble_batch(pools, meta, out_hw: tuple[int, int]):
    """Metadata batch (tensors on the pools' device) -> the streaming
    path's uint8 pixel batch: data (B, d, h, w, 3), loc_msk (B, d, h, w, 1)
    with the per-frame validity ANDed in, and the passthrough scalars."""
    data, mask = _gather_clips(
        pools["pool_video"], pools["pool_mask"], meta["frame_idx"],
        meta["crop_y"], meta["crop_x"], out_hw,
    )
    # valid is float32 {0, 1}: compare-then-cast, as the JAX package does,
    # so a fractional validity can never truncate to 0 in silence
    valid_u8 = (meta["valid"] > 0).to(torch.uint8)
    batch = {
        "data": data,
        "loc_msk": mask * valid_u8[:, :, None, None, None],
        "action": meta["action"],
        "label_vid": meta["label_vid"],
    }
    if "row_mask" in meta:
        batch["row_mask"] = meta["row_mask"]
    return batch


def make_assembler_put(pools, out_hw: tuple[int, int], *, device=None):
    """PrefetchLoader `put_fn`: host metadata batch -> pixel batch on
    `device` (default: the CUDA card), where the pools must lie.  The
    ~100-byte metadata copies and the gather both run on the loader's
    producer thread and side stream, overlapping the previous step."""
    dev = resolve_device(device)
    for name, pool in pools.items():
        if pool.device.type != dev.type or dev.index not in (None, pool.device.index):
            raise ValueError(f"{name} lies on {pool.device}, the assembler on {dev}")

    def put(meta):
        meta = {k: torch.as_tensor(np.asarray(v)).to(dev, non_blocking=True)
                for k, v in meta.items()}
        return assemble_batch(pools, meta, out_hw)

    return put


def assemble_clips_on_device(pool_video, pool_mask, frame_idx, crop_y, crop_x, valid,
                             out_hw: tuple[int, int]):
    """On-device clip assembly -> (data uint8 (B, d, h, w, 3), seg f32
    (B, d, h, w)): data = video[span][crop] (normalized later in
    prepare_views), seg = (mask[span][crop] > 0) & valid.  The metadata
    may be numpy arrays or tensors."""
    dev = pool_video.device

    def t(a):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               device=dev)

    data, mask = _gather_clips(pool_video, pool_mask, t(frame_idx), t(crop_y), t(crop_x),
                               out_hw)
    seg = mask[..., 0].to(torch.float32) * t(valid)[:, :, None, None]
    return data, seg
