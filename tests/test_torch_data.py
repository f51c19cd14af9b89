"""The port's input pipeline against the JAX package's, CPU.

Mirrors tests/test_data.py, test_native.py, test_video_cache.py,
test_loader.py and test_parity_inputs.py: the same sources, seeds and
tiny videos (written with cv2 into tmp_path) go through both packages,
and every record, sample and batch must be identical (every key, dtype
and shape, np.array_equal).  PrefetchLoader runs on device="cpu".
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from picad_tpu.data import dataset as jax_dataset
from picad_tpu.data import loader as jax_loader
from picad_tpu.data import sources as jax_sources
from picad_tpu_torch.data import _native as port_native
from picad_tpu_torch.data import dataset as port_dataset
from picad_tpu_torch.data import loader as port_loader
from picad_tpu_torch.data import sources as port_sources
from picad_tpu_torch.train.step import prepare_views
from tests.test_torch_model import few_torch_threads  # noqa: F401

PKGS = {"jax": (jax_sources, jax_dataset, jax_loader),
        "port": (port_sources, port_dataset, port_loader)}


def assert_same(a, b, where=""):
    """Identical values: dicts key by key, records field by field."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (port_sources.VideoRecord, jax_sources.VideoRecord)):
        for f in ("video", "mask", "label", "annot_frames", "labeled", "name"):
            assert_same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, (str, int)):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert np.array_equal(a, b), where


def _synthetic(pkg, n=4, labeled=0.5, seed=3, video_len=24):
    return PKGS[pkg][0].SyntheticVideoSource(n, video_len=video_len, height=96, width=112,
                                             labeled_fraction=labeled, seed=seed)


# ---- sources ----------------------------------------------------------------


def test_synthetic_and_composite_sources_match_jax():
    srcs = {}
    for pkg, (S, _, _) in PKGS.items():
        cat = S.ConcatVideoSource([_synthetic(pkg, 2, seed=1), _synthetic(pkg, 3, seed=2)])
        srcs[pkg] = S.CachedVideoSource(cat, capacity_bytes=1 << 30)
    assert len(srcs["port"]) == len(srcs["jax"]) == 5
    for i in (0, 1, 2, 4, 2):  # 2 twice: the second read is an LRU hit
        assert_same(srcs["port"].load(i), srcs["jax"].load(i), f"video {i}")


ANNOTATIONS = [
    [(2, 5, 7, [(1, 1, 2, 2)] * 4, [3], 1)],  # tests/test_data.py
    [(0, 5, 1, [(0, 0, 2, 2), (1, 0, 2, 2), (2, 0, 2, 2), (3, 0, 2, 2), (4, 0, 2, 2),
                (4, 1, 2, 2)], [0, 4], 1)],
    [(1, 6, 3, [(1, 2, 3, 2)] * 6, [2, 3, 6], 0),  # two tracks, keyframes 1 apart
     (0, 3, 3, [(4, 4, 2, 3)] * 4, [1], 0)],
    [(3, 7, 2, [(2, 2, 3, 3)] * 5, [9], 1)],  # keyframe past the video: no box
]


@pytest.mark.parametrize("k", range(len(ANNOTATIONS)))
def test_rasterize_matches_jax(k):
    anns = ANNOTATIONS[k]
    assert_same(port_sources.rasterize_boxes(8, 8, 8, anns),
                jax_sources.rasterize_boxes(8, 8, 8, anns))
    assert_same(port_sources.rasterize_keyframe_boxes(8, 8, 8, anns[0]),
                jax_sources.rasterize_keyframe_boxes(8, 8, 8, anns[0]))


def _write_avi(path, frames_bgr):
    import cv2

    h, w = frames_bgr[0].shape[:2]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
    if not vw.isOpened():
        pytest.skip("cv2 has no MJPG encoder in this build")
    for f in frames_bgr:
        vw.write(f)
    vw.release()


@pytest.fixture
def ucf_tree(tmp_path):
    """Two UCF videos of 12 64x80 frames (the second with two annotation
    tracks) and a third whose .avi is missing."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    records = []
    for i, n_tracks in enumerate((1, 2, 1)):
        name = f"Golf/v_Golf_g0{i}_c01"
        if i < 2:
            frames = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8) for _ in range(12)]
            _write_avi(tmp_path / "UCF101_Videos" / f"{name}.avi", frames)
        anns = [(t, 9 + t, 5 + i, [(4 + t, 6, 20, 30 - t)] * 10, [t + 2, t + 6], 1 - i % 2)
                for t in range(n_tracks)]
        records.append((name, anns))
    pkl = tmp_path / "annots.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    return str(pkl), str(tmp_path)


@pytest.mark.parametrize("kw", [{}, {"single_annotation": True},
                                {"single_annotation": True, "keyframe_masks": True},
                                {"decoded_cache_dir": "npy"}])
def test_ucf_source_matches_jax(ucf_tree, tmp_path, kw):
    pkl, root = ucf_tree
    if "decoded_cache_dir" in kw:
        kw = {"decoded_cache_dir": str(tmp_path / kw["decoded_cache_dir"])}
    port = port_sources.UCFVideoSource(pkl, root, **kw)
    ref = jax_sources.UCFVideoSource(pkl, root, **kw)
    assert port._annot_choice == ref._annot_choice
    for i in (0, 1, 2, 0):  # 0 twice: from the .npy cache when it is on
        assert_same(port.load(i), ref.load(i), f"video {i}")
    assert port.load(0).video.shape == (12, 64, 80, 3) and port.load(2) is None


def test_ucf_annotation_draw_is_the_legacy_stream(tmp_path):
    """The single-annotation table: legacy MT19937 seeded 47, one draw per
    video with more than one annotation (tests/test_parity_inputs.py)."""
    counts = [int(c) for c in np.random.default_rng(123).integers(1, 6, size=60)]
    records = [(f"fake/v{i}", [(0, 10, 1, [[1, 1, 4, 4]] * 11, [2], 1)] * n)
               for i, n in enumerate(counts)]
    pkl = tmp_path / "t.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    np.random.seed(47)
    expected = [int(np.random.randint(0, n)) if n > 1 else 0 for n in counts]
    port = port_sources.UCFVideoSource(str(pkl), ".", single_annotation=True)
    assert port._annot_choice == expected
    assert port._annot_choice == jax_sources.UCFVideoSource(
        str(pkl), ".", single_annotation=True)._annot_choice


def test_skvideo_decoder_fails_loud(tmp_path):
    try:
        import skvideo  # noqa: F401

        pytest.skip("scikit-video present; the import guard is not reachable")
    except ImportError:
        pass
    pkl = tmp_path / "t.pkl"
    with open(pkl, "wb") as f:
        pickle.dump([("fake/v0", [(0, 3, 1, [[1, 1, 2, 2]] * 4, [1], 1)])], f)
    src = port_sources.UCFVideoSource(str(pkl), str(tmp_path), decoder="skvideo")
    with pytest.raises(ImportError, match="scikit-video"):
        src.load(0)
    with pytest.raises(ValueError, match="decoder"):
        port_sources.UCFVideoSource(str(pkl), str(tmp_path), decoder="ffmpeg")


@pytest.fixture
def jhmdb_tree(tmp_path):
    """One JHMDB video (golf/clip, 6 frames of 60x80, blue-heavy BGR)
    with a raw-resolution puppet mask."""
    pytest.importorskip("cv2")
    from scipy.io import savemat

    h, w, n = 60, 80, 6
    frame = np.zeros((h, w, 3), np.uint8)
    frame[..., 0], frame[..., 2] = 200, 30
    _write_avi(tmp_path / "videos" / "golf" / "clip.avi", [frame] * n)
    mask = np.zeros((h, w, n), np.uint8)
    mask[10:40, 20:60] = 1
    os.makedirs(tmp_path / "masks" / "golf" / "clip")
    savemat(tmp_path / "masks" / "golf" / "clip" / "puppet_mask.mat", {"part_mask": mask})
    (tmp_path / "list.txt").write_text("golf/clip\n")
    return [str(tmp_path / "list.txt"), str(tmp_path / "videos"), str(tmp_path / "masks")]


@pytest.mark.parametrize("order,resize", [("reference", 256), ("rgb", 256),
                                          ("reference", None)])
def test_jhmdb_source_matches_jax(jhmdb_tree, tmp_path, order, resize):
    cache = str(tmp_path / "npy")
    port = port_sources.JHMDBVideoSource(*jhmdb_tree, decoded_cache_dir=cache,
                                         channel_order=order, resize=resize)
    ref = jax_sources.JHMDBVideoSource(*jhmdb_tree, channel_order=order, resize=resize)
    rec = port.load(0)
    assert_same(rec, ref.load(0))
    assert_same(port.load(0), rec)  # the second load comes from the .npy cache
    assert rec.video.shape[1:3] == ((256, 256) if resize else (60, 80))
    blue = rec.video[..., 0 if order == "reference" else 2].mean()
    assert blue > 150  # BGR order kept for 'reference'


# ---- datasets ---------------------------------------------------------------


@pytest.mark.parametrize("device_prep", [False, True])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("with_validity", [False, True])
def test_clip_dataset_matches_jax(device_prep, use_native, with_validity):
    kw = dict(train=True, clip_shape=(48, 64), seed=5, device_prep=device_prep,
              use_native=use_native, with_validity=with_validity)
    port = port_dataset.ClipDataset(_synthetic("port"), **kw)
    ref = jax_dataset.ClipDataset(_synthetic("jax"), **kw)
    assert (port._native is not None) == (ref._native is not None) == (
        use_native and port_native.available())
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(port)):
            assert_same(port[i], ref[i], f"epoch {epoch} sample {i}")
            if device_prep:
                bufs = {}
                for name, ds in (("port", port), ("jax", ref)):
                    spec = ds.batch_spec()
                    out = {k: np.full(s, 7, d) for k, (s, d) in spec.items()}
                    lab = ds.fill_into(i, out["data"], out["loc_msk"], out.get("mask_cls"))
                    bufs[name] = (out, lab)
                assert_same(bufs["port"], bufs["jax"], f"fill_into {i}")
    val = [P[1].ClipDataset(_synthetic(p), train=False, clip_shape=(48, 64))[1]
           for p, P in PKGS.items()]
    assert_same(val[0], val[1], "val sample")


def test_degraded_samples_match_jax():
    class Failing:
        def __len__(self):
            return 2

        def load(self, i):
            return None

    short = {p: _synthetic(p, 2, video_len=6) for p in PKGS}  # 8 frames do not fit
    for dp in (False, True):
        for src in (lambda p: Failing(), lambda p: short[p]):
            s = [PKGS[p][1].ClipDataset(src(p), train=True, clip_shape=(48, 64),
                                        device_prep=dp)[0] for p in PKGS]
            assert_same(s[0], s[1])
            assert int(s[0]["label_vid"]) == 0 and not np.any(s[0]["data"])


def test_eval_video_dataset_matches_jax():
    a = port_dataset.EvalVideoDataset(_synthetic("port", 2), clip_shape=(48, 64),
                                      return_name=True)
    b = jax_dataset.EvalVideoDataset(_synthetic("jax", 2), clip_shape=(48, 64),
                                     return_name=True)
    assert_same(list(a), list(b))


def test_device_prep_layout_equivalence():
    """uint8 device_prep sample -> prepare_views == the reference float
    sample (tests/test_data.py)."""
    src = _synthetic("port", 2, seed=9)
    ref = port_dataset.ClipDataset(src, train=True, clip_shape=(48, 64), seed=3)[0]
    dev = port_dataset.ClipDataset(src, train=True, clip_shape=(48, 64), seed=3,
                                   device_prep=True)[0]
    assert dev["data"].dtype == np.uint8 and "aug_data" not in dev
    data, aug, seg = prepare_views({"data": dev["data"][None], "loc_msk": dev["loc_msk"][None]},
                                   torch.device("cpu"))
    np.testing.assert_allclose(data[0].numpy(), ref["data"], atol=1e-6)
    np.testing.assert_allclose(aug[0].numpy(), ref["aug_data"], atol=1e-6)
    np.testing.assert_array_equal(seg[0].numpy(), ref["loc_msk"][..., 0])


# ---- the native library -------------------------------------------------------


@pytest.fixture
def fresh_native(monkeypatch):
    port_native.load_library.cache_clear()
    yield monkeypatch
    port_native.load_library.cache_clear()


def test_native_missing_means_numpy_and_broken_raises(fresh_native, tmp_path):
    fresh_native.setattr(port_native, "LIBRARY_PATH", str(tmp_path / "absent.so"))
    assert not port_native.available()
    ds = port_dataset.ClipDataset(_synthetic("port"), train=True, clip_shape=(48, 64))
    assert ds._native is None
    broken = tmp_path / "libclip_ops.so"
    broken.write_bytes(b"not an ELF file")
    fresh_native.setattr(port_native, "LIBRARY_PATH", str(broken))
    port_native.load_library.cache_clear()
    with pytest.raises(OSError):
        port_dataset.ClipDataset(_synthetic("port"), train=True, clip_shape=(48, 64))


@pytest.mark.skipif(not os.path.exists(port_native.LIBRARY_PATH), reason="libclip_ops.so not built")
def test_native_kernels_match_numpy():
    """tests/test_native.py on the port's bindings, plus the range checks."""
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (20, 60, 80, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(20, 60, 80, 1)) > 0.5).astype(np.uint8)
    span = np.arange(0, 16, 2, dtype=np.int64)
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.uint8)
    out, flip, msk = port_native.assemble_clip(video, mask, span, valid, 5, 7, 48, 64)
    ref = video[span, 5:53, 7:71].astype(np.float32) / 255.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(flip, ref[:, :, ::-1], rtol=0, atol=1e-7)
    mref = (mask[span, 5:53, 7:71] > 0) & valid[:, None, None, None].astype(bool)
    np.testing.assert_array_equal(msk, mref.astype(np.float32))
    d = np.zeros((8, 48, 64, 3), np.uint8)
    m = np.zeros((8, 48, 64, 1), np.uint8)
    port_native.crop_gather_u8(video, mask, span, valid, 5, 7, d, m)
    np.testing.assert_array_equal(d, video[span, 5:53, 7:71])
    np.testing.assert_array_equal(m, mref.astype(np.uint8))
    with pytest.raises(ValueError, match="outside"):
        port_native.crop_gather_u8(video, mask, span, valid, 20, 7, d, m)


# ---- batching ---------------------------------------------------------------


class _NoFill:
    """Hides fill_into so the batcher takes the generic slow path."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def set_epoch(self, e):
        self.ds.set_epoch(e)


def _batcher(pkg, *, fast=True, n_unlabeled=6, **kw):
    S, D, L = PKGS[pkg]

    def ds(labeled, seed, n):
        d = D.ClipDataset(S.CachedVideoSource(_synthetic(pkg, n, labeled, seed)), train=True,
                          clip_shape=(48, 64), device_prep=True)
        return d if fast else _NoFill(d)

    return L.SemiSupervisedBatcher(ds(1.0, 1, 5), ds(0.0, 2, n_unlabeled), batch_size=4,
                                   seed=0, workers=2, process_index=0, process_count=1, **kw)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("n_unlabeled,drop_last", [(6, False), (7, False), (7, True)])
def test_batcher_matches_jax(fast, n_unlabeled, drop_last):
    """Two epochs of batches, on the fast (fill_into) and the slow path,
    with and without a ragged final batch."""
    port = _batcher("port", fast=fast, n_unlabeled=n_unlabeled, drop_last=drop_last)
    ref = _batcher("jax", fast=fast, n_unlabeled=n_unlabeled, drop_last=drop_last)
    assert port.steps_per_epoch() == ref.steps_per_epoch()
    for epoch in (0, 1):
        a, b = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(a) == len(b) == port.steps_per_epoch()
        assert_same(a, b, f"epoch {epoch}")
    if fast:  # yielded batches never alias (tests/test_loader.py)
        ptrs = [bt["data"].__array_interface__["data"][0] for bt in a]
        assert len(set(ptrs)) == len(ptrs)


def test_batcher_process_defaults_and_shards():
    S, D, L = PKGS["port"]
    ds = D.ClipDataset(_synthetic("port"), train=True, clip_shape=(48, 64))
    b = L.SemiSupervisedBatcher(ds, ds, batch_size=2)
    assert (b.process_index, b.process_count) == (0, 1)  # torch.distributed not initialized
    with pytest.raises(ValueError, match="half"):
        L.SemiSupervisedBatcher(ds, ds, batch_size=3)
    order = np.random.default_rng((0, 1)).permutation(len(ds))
    shards = [set(L.SemiSupervisedBatcher(ds, ds, batch_size=2, process_index=i,
                                          process_count=2)._host_shard(order).tolist())
              for i in range(2)]
    assert shards[0].isdisjoint(shards[1]) and shards[0] | shards[1] == set(range(len(ds)))


def test_prefetch_loader_order_count_and_transform():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(7)]
    out = list(port_loader.PrefetchLoader(iter(batches), prefetch=2, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
    loader = port_loader.PrefetchLoader(iter(batches[:3]), prefetch=1, device="cpu",
                                        transform=lambda b: {"x": b["x"] * 2.0},
                                        put_fn=lambda b: b)
    assert [float(b["x"][0, 0]) for b in loader] == [0.0, 2.0, 4.0]


def test_prefetch_loader_raises_producer_errors_and_stops_on_close():
    def failing():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("decode failed")

    it = iter(port_loader.PrefetchLoader(failing(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    def endless():
        i = 0
        while True:
            yield {"x": np.full(2, i, np.float32)}
            i += 1

    before = threading.active_count()
    it = iter(port_loader.PrefetchLoader(endless(), prefetch=2, device="cpu"))
    assert [float(next(it)["x"][0]) for _ in range(3)] == [0.0, 1.0, 2.0]
    it.close()  # stops and joins the producer
    assert threading.active_count() == before
