"""ctypes bindings for the native clip-preprocessing library.

The port's own loader of the tracked `native/libclip_ops.so` (built by
`make -C native`; picad_tpu/data/_native.py:18-60 is the JAX package's).
A missing file means the numpy path.  A file that exists but does not
load raises (ctypes' OSError): it is not passed over in silence.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

LIBRARY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libclip_ops.so",
)


@functools.lru_cache(maxsize=None)
def load_library():
    """The loaded library, or None when the file does not exist."""
    if not os.path.exists(LIBRARY_PATH):
        return None
    lib = ctypes.CDLL(LIBRARY_PATH)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.assemble_clip.argtypes = [
        u8p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        i64p, u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, f32p, f32p,
    ]
    lib.assemble_clip.restype = None
    lib.crop_gather_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        i64p, u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.crop_gather_u8.restype = None
    return lib


def available() -> bool:
    return load_library() is not None


def _check_crop(shape, y0: int, x0: int, ch: int, cw: int, span) -> None:
    F, H, W = shape[:3]
    if not (0 <= y0 and y0 + ch <= H and 0 <= x0 and x0 + cw <= W):
        raise ValueError(f"crop ({y0}, {x0}) + ({ch}, {cw}) outside the {H}x{W} frame")
    if len(span) and not (0 <= int(np.min(span)) and int(np.max(span)) < F):
        raise ValueError(f"frame span outside the video's {F} frames")


def assemble_clip(video, mask, span, valid, y0: int, x0: int, ch: int, cw: int):
    """Fused crop + /255 + flip + mask threshold (native/clip_ops.cc):
    (data, flipped data, mask), each (depth, ch, cw, c) f32."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"{LIBRARY_PATH} is not built")
    depth = len(span)
    video = np.ascontiguousarray(video, dtype=np.uint8)
    F, H, W, _ = video.shape
    _check_crop(video.shape, y0, x0, ch, cw, span)
    out = np.empty((depth, ch, cw, 3), np.float32)
    out_flip = np.empty((depth, ch, cw, 3), np.float32)
    out_mask = np.empty((depth, ch, cw, 1), np.float32)
    span = np.ascontiguousarray(span, dtype=np.int64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask.reshape(F, H, W), dtype=np.uint8)
        mask_ptr = mask.ctypes.data_as(ctypes.c_void_p)
    lib.assemble_clip(
        video, mask_ptr, H, W, span, valid, depth, y0, x0, ch, cw,
        out, out_flip, out_mask.reshape(depth, ch, cw),
    )
    return out, out_flip, out_mask


def crop_gather_u8(video, mask, span, valid, y0: int, x0: int, out_data, out_mask) -> None:
    """uint8 crop-gather straight into batch-slot views (native/clip_ops.cc):
    out_data (depth, ch, cw, 3) = video[span][crop], out_mask (depth, ch,
    cw, 1) = (mask[span][crop] > 0) & valid.  The ctypes call releases
    the GIL, so assembly overlaps the train step's host work."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"{LIBRARY_PATH} is not built")
    depth, ch, cw, _ = out_data.shape
    for name, a in (("video", video), ("mask", mask), ("out_data", out_data),
                    ("out_mask", out_mask)):
        if a is not None and not (a.dtype == np.uint8 and a.flags.c_contiguous):
            raise ValueError(f"{name} must be C-contiguous uint8")
    if out_mask.shape != (depth, ch, cw, 1) or len(span) != depth:
        raise ValueError(f"out_mask {out_mask.shape} / span {len(span)} do not match "
                         f"out_data {out_data.shape}")
    _check_crop(video.shape, y0, x0, ch, cw, span)
    _, H, W, _ = video.shape
    span = np.ascontiguousarray(span, dtype=np.int64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    mask_ptr = None if mask is None else ctypes.c_void_p(mask.ctypes.data)
    lib.crop_gather_u8(
        ctypes.c_void_p(video.ctypes.data), mask_ptr, H, W,
        span, valid, depth, y0, x0, ch, cw,
        ctypes.c_void_p(out_data.ctypes.data),
        ctypes.c_void_p(out_mask.ctypes.data),
    )
