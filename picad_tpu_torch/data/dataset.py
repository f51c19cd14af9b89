"""Clip sampling datasets (train/val) and whole-video eval datasets.

`ClipDataset.__getitem__` replicates the reference sampling rules
(datasets/ucf_dataloader.py:86-191):

- pick a random annotated frame; start = frame - depth*vskip/2, falling
  back vskip 2 -> 1 at the left boundary, clamping to 0, and sliding the
  window left at the right boundary (:125-148);
- a selected frame beyond the video, a failed decode, or an empty
  annotation list yields an all-zero sample flagged unlabeled
  (:96-121, :133-140);
- frames at `start + arange(depth) * vskip`, random 224-crop (train) /
  center crop (val), /255 normalize (:145-172);
- per-frame label mask from the cropped box heat map (any positive pixel
  -> 1, :169-172);
- `aug_data` = horizontal flip (:175).

JHMDB adds the per-frame validity channel `mask_cls`: a frame's mask (and
validity) is set only when its span index (or +1 at vskip=2) is annotated
(datasets/jhmdb_dataloader.py:196-210).  For UCF the validity volume is
all-ones, so a single code path serves both.

Samples are channels-last: data (8, 224, 224, 3), the layout the train
step takes (train/step.py).  The port's copy of picad_tpu/data/dataset.py:
the same samples, bit for bit, for one seed.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from picad_tpu_torch.data import _native


def _center_or_random_crop(h, w, out_h, out_w, train: bool, rng):
    if train:
        y = int(rng.integers(0, h - out_h)) if h > out_h else 0
        x = int(rng.integers(0, w - out_w)) if w > out_w else 0
    else:
        y = (h - out_h) // 2
        x = (w - out_w) // 2
    return y, x


class ClipDataset:
    """Samples fixed-length clips for training/validation."""

    def __init__(
        self,
        source,
        *,
        train: bool,
        clip_shape=(224, 224),
        depth: int = 8,
        vskip: int = 2,
        with_validity: bool = False,
        seed: int = 0,
        use_native: bool = True,
        device_prep: bool = False,
    ):
        """device_prep=True is the uint8 sample layout: `data` stays
        cropped uint8 (no /255, no host flip, no `aug_data` key) and the
        train/val step normalizes and flips on the device — the same
        numbers at 1/8 the host-to-device bytes of the f32 data and
        aug_data, and a fraction of the host work.  False reproduces the
        reference sample dict
        (ucf_dataloader.py:189) exactly.  `use_native` takes the native
        library (data/_native.py) when it is built."""
        self.source = source
        self.train = train
        self.height, self.width = clip_shape
        self.depth = depth
        self.vskip = vskip
        self.with_validity = with_validity
        self.seed = seed
        self.device_prep = device_prep
        self._epoch = 0
        self._native = _native if use_native and _native.available() else None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.source)

    def _zero_sample(self) -> dict[str, Any]:
        d, h, w = self.depth, self.height, self.width
        if self.device_prep:
            sample = {
                "data": np.zeros((d, h, w, 3), dtype=np.uint8),
                "loc_msk": np.zeros((d, h, w, 1), dtype=np.uint8),
                "action": np.int32(0),
                "label_vid": np.int32(0),
            }
        else:
            zero_v = np.zeros((d, h, w, 3), dtype=np.float32)
            zero_m = np.zeros((d, h, w, 1), dtype=np.float32)
            sample = {
                "data": zero_v,
                "aug_data": zero_v,
                "loc_msk": zero_m,
                "action": np.int32(0),
                "label_vid": np.int32(0),
            }
        if self.with_validity:
            sample["mask_cls"] = np.zeros((d, h, w, 1), dtype=np.float32)
        return sample

    def zero_sample(self) -> dict[str, Any]:
        """Public degraded-sample constructor — also the cheap shape/dtype
        template for all-pad lockstep steps (train/loop.py validate): no
        video decode, unlike fetching a real sample for its shapes."""
        return self._zero_sample()

    def _sample_plan(self, index: int, source_index: int | None = None):
        """The cheap per-sample logic: clip span + crop origin + validity.

        Returns None for a degraded (all-zero) sample, else
        (rec, span, y, x, valid).  `source_index` lets a view over a
        merged source (device_cache.DeviceClipDataset) keep the rng
        stream keyed by the LOCAL index — identical sampling decisions
        to a per-source host dataset."""
        rng = np.random.default_rng((self.seed, self._epoch, index))
        rec = self.source.load(index if source_index is None else source_index)
        if rec is None or len(rec.annot_frames) == 0:
            return None

        depth = self.depth
        vlen, clip_h, clip_w, _ = rec.video.shape
        annot_frames = np.asarray(rec.annot_frames)

        if len(annot_frames) == 1:
            selected = int(annot_frames[0])
        else:
            selected = int(annot_frames[rng.integers(0, len(annot_frames))])

        vskip = self.vskip
        start = selected - (depth * vskip) // 2
        if start < 0:
            vskip = 1
            start = selected - (depth * vskip) // 2
            if start < 0:
                start = 0
                vskip = 1
        if selected >= vlen:
            return None
        if start + depth * vskip >= vlen:
            start = vlen - depth * vskip
        # A very short video can still underflow; degrade like a decode
        # failure rather than wrapping around.
        if start < 0:
            return None

        span = np.arange(depth) * vskip + start

        y, x = _center_or_random_crop(
            clip_h, clip_w, self.height, self.width, self.train, rng
        )

        # per-frame validity (JHMDB mask_cls rule, jhmdb_dataloader.py:196-210;
        # all frames valid for UCF)
        if self.with_validity:
            annot_set = set(int(f) for f in annot_frames)
            if vskip == 2:
                valid = np.array(
                    [(s in annot_set) or (s + 1 in annot_set) for s in span],
                    dtype=np.uint8,
                )
            else:
                valid = np.array([s in annot_set for s in span], dtype=np.uint8)
        else:
            valid = np.ones((depth,), dtype=np.uint8)
        return rec, span, y, x, valid

    @property
    def supports_fill(self) -> bool:
        """True when fill_into() is the fast path (the uint8 layout)."""
        return self.device_prep

    def batch_spec(self) -> dict[str, tuple[tuple, np.dtype]]:
        """Per-sample array fields of the device_prep layout, for
        preallocating reusable batch buffers (loader fast path)."""
        d, h, w = self.depth, self.height, self.width
        spec = {
            "data": ((d, h, w, 3), np.dtype(np.uint8)),
            "loc_msk": ((d, h, w, 1), np.dtype(np.uint8)),
        }
        if self.with_validity:
            spec["mask_cls"] = ((d, h, w, 1), np.dtype(np.float32))
        return spec

    def fill_into(
        self,
        index: int,
        data_out: np.ndarray,
        loc_out: np.ndarray,
        mask_cls_out: np.ndarray | None = None,
    ) -> tuple[int, int]:
        """Assemble the device_prep sample straight into batch-slot views.

        Same numerics as __getitem__ (device_prep branch) with zero
        intermediate allocations; the gather goes through the native
        GIL-releasing assembler when available.  Returns (action,
        label_vid)."""
        if not self.device_prep:
            raise ValueError("fill_into assembles the device_prep layout only")
        plan = self._sample_plan(index)
        if plan is None:
            data_out[...] = 0
            loc_out[...] = 0
            if mask_cls_out is not None:
                mask_cls_out[...] = 0.0
            return 0, 0
        rec, span, y, x, valid = plan
        video, mask = rec.video, rec.mask
        if (
            self._native is not None
            and video.dtype == np.uint8
            and video.flags.c_contiguous
            and mask.dtype == np.uint8
            and mask.flags.c_contiguous
        ):
            _native.crop_gather_u8(
                video, mask, span, valid, y, x, data_out, loc_out
            )
        else:
            if video.dtype != np.uint8:
                raise ValueError("device_prep requires uint8 video sources")
            data_out[...] = video[
                span, y : y + self.height, x : x + self.width, :
            ]
            m = mask[span, y : y + self.height, x : x + self.width, :]
            loc_out[...] = (m > 0) & valid[:, None, None, None].astype(bool)
        if mask_cls_out is not None:
            mask_cls_out[...] = valid.astype(np.float32)[:, None, None, None]
        return int(rec.label), int(rec.labeled)

    def __getitem__(self, index: int) -> dict[str, Any]:
        plan = self._sample_plan(index)
        if plan is None:
            return self._zero_sample()
        rec, span, y, x, valid = plan
        depth = self.depth

        if self.device_prep and rec.video.dtype == np.uint8:
            # uint8 crop-gather only; /255, flip, mask threshold move into
            # the step (train/step.py prepare_views)
            data = np.ascontiguousarray(
                rec.video[span, y : y + self.height, x : x + self.width, :]
            )
            mask = rec.mask[span, y : y + self.height, x : x + self.width, :]
            loc = (
                (mask > 0) & valid[:, None, None, None].astype(bool)
            ).astype(np.uint8)
            sample = {
                "data": data,
                "loc_msk": loc,
                "action": np.int32(rec.label),
                "label_vid": np.int32(rec.labeled),
            }
            if self.with_validity:
                sample["mask_cls"] = np.broadcast_to(
                    valid.astype(np.float32)[:, None, None, None],
                    (depth, self.height, self.width, 1),
                ).copy()
            return sample

        if self._native is not None and rec.video.dtype == np.uint8:
            data, aug, loc = self._native.assemble_clip(
                rec.video, rec.mask, span, valid, y, x, self.height, self.width
            )
        else:
            video = rec.video[span, y : y + self.height, x : x + self.width, :]
            mask = rec.mask[span, y : y + self.height, x : x + self.width, :]
            data = (video.astype(np.float32) / 255.0).astype(np.float32)
            aug = np.ascontiguousarray(data[:, :, ::-1, :])
            loc = ((mask > 0) & valid[:, None, None, None].astype(bool)).astype(
                np.float32
            )

        sample = {
            "data": data,
            "aug_data": aug,
            "loc_msk": loc,
            "action": np.int32(rec.label),
            "label_vid": np.int32(rec.labeled),
        }
        if self.with_validity:
            sample["mask_cls"] = np.broadcast_to(
                valid.astype(np.float32)[:, None, None, None],
                (depth, self.height, self.width, 1),
            ).copy()
        return sample


class EvalVideoDataset:
    """Whole-video eval samples: center-cropped video + mask volume + label.

    Matches datasets/ucf_dataloader_eval.py:87-107 /
    jhmdb_dataloader_eval.py:83-99: no temporal sampling — chunking
    happens in eval.clips.
    """

    def __init__(self, source, *, clip_shape=(224, 224), return_name: bool = False):
        self.source = source
        self.height, self.width = clip_shape
        self.return_name = return_name

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int):
        rec = self.source.load(index)
        if rec is None:
            return None
        _, h, w, _ = rec.video.shape
        y = (h - self.height) // 2
        x = (w - self.width) // 2
        video = rec.video[:, y : y + self.height, x : x + self.width, :].astype(
            np.float32
        ) / 255.0
        mask = rec.mask[:, y : y + self.height, x : x + self.width, :]
        if self.return_name:
            return video, mask, rec.label, rec.name or str(index)
        return video, mask, rec.label

    def __iter__(self):
        for i in range(len(self)):
            item = self[i]
            if item is not None:
                yield item
