"""The port's device-resident video cache on device="cpu", against the
JAX package's and against the host streaming path (mirrors
tests/test_device_cache.py): the pools, the sampling, and the assembled
batches are identical, bit for bit, and a train step on a cache batch is
the step on the host batch.
"""

import jax
import numpy as np
import pytest
import torch

from picad_tpu.data import device_cache as jax_cache
from picad_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from picad_tpu.data.loader import SemiSupervisedBatcher as JaxBatcher
from picad_tpu.data.sources import SyntheticVideoSource as JaxSynthetic
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.data.dataset import ClipDataset
from picad_tpu_torch.data.device_cache import (
    DeviceClipDataset,
    DeviceVideoCache,
    assemble_clips_on_device,
    make_assembler_put,
)
from picad_tpu_torch.data.loader import PrefetchLoader, SemiSupervisedBatcher
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step
from tests.test_torch_model import few_torch_threads  # noqa: F401

HW = (48, 64)
CPU = torch.device("cpu")


def make_source(cls=SyntheticVideoSource, n=6):
    return cls(n, video_len=24, height=96, width=112, labeled_fraction=0.5, seed=3)


@pytest.fixture(scope="module")
def cache():
    return DeviceVideoCache.build(make_source(), budget_bytes=1 << 30, device="cpu")


@pytest.fixture(scope="module")
def jax_pools():
    c = jax_cache.DeviceVideoCache.build(make_source(JaxSynthetic), budget_bytes=1 << 30)
    return c, {"pool_video": c.pool_video, "pool_mask": c.pool_mask}


def test_pools_match_jax(cache, jax_pools):
    ref, _ = jax_pools
    assert cache.pool_video.device == CPU and cache.pool_video.dtype == torch.uint8
    np.testing.assert_array_equal(cache.pool_video.numpy(), np.asarray(ref.pool_video))
    np.testing.assert_array_equal(cache.pool_mask.numpy(), np.asarray(ref.pool_mask))
    np.testing.assert_array_equal(cache.offsets, ref.offsets)
    assert cache.frame_hw == ref.frame_hw


def test_sampling_parity_with_host_dataset(cache):
    """Same rng stream => the same clip span, crop and flags as ClipDataset."""
    host = ClipDataset(make_source(), train=True, clip_shape=HW, device_prep=True, seed=5)
    meta = DeviceClipDataset(cache, train=True, clip_shape=HW, seed=5)
    for epoch in (0, 1):
        host.set_epoch(epoch)
        meta.set_epoch(epoch)
        for i in range(len(host)):
            hs, ms = host[i], meta[i]
            data, seg = assemble_clips_on_device(
                cache.pool_video, cache.pool_mask, ms["frame_idx"][None],
                np.asarray([ms["crop_y"]]), np.asarray([ms["crop_x"]]), ms["valid"][None], HW)
            assert torch.equal(data[0], torch.from_numpy(hs["data"]))
            assert torch.equal(seg[0], torch.from_numpy(hs["loc_msk"][..., 0].astype(np.float32)))
            assert int(ms["action"]) == int(hs["action"])
            assert int(ms["label_vid"]) == int(hs["label_vid"])


def _meta_batcher(cache, pkg_cls=(DeviceClipDataset, SemiSupervisedBatcher), hw=HW, bs=4):
    ds_cls, batcher_cls = pkg_cls
    return batcher_cls(ds_cls(cache, train=True, clip_shape=hw, seed=1),
                       ds_cls(cache, train=True, clip_shape=hw, seed=2), batch_size=bs,
                       seed=0, workers=2, process_index=0, process_count=1)


def _host_batcher(hw=HW, bs=4):
    def ds(seed):
        return ClipDataset(make_source(), train=True, clip_shape=hw, device_prep=True, seed=seed)

    return SemiSupervisedBatcher(ds(1), ds(2), batch_size=bs, seed=0, workers=2,
                                 process_index=0, process_count=1)


def test_assembler_batch_matches_jax_and_host_streaming(cache, jax_pools):
    """Metadata batches through PrefetchLoader + make_assembler_put give
    the JAX assembler's pixel batches and the host streaming batches,
    bit for bit, over two epochs."""
    jc, jpools = jax_pools
    put = make_assembler_put({"pool_video": cache.pool_video, "pool_mask": cache.pool_mask},
                             HW, device="cpu")
    for epoch in (0, 1):
        port = list(PrefetchLoader(_meta_batcher(cache).epoch(epoch), put_fn=put,
                                   device="cpu"))
        ref = list(JaxPrefetchLoader(
            _meta_batcher(jc, (jax_cache.DeviceClipDataset, JaxBatcher)).epoch(epoch),
            put_fn=jax_cache.make_assembler_put(jpools, HW)))
        host = list(_host_batcher().epoch(epoch))
        assert len(port) == len(ref) == len(host) > 0
        for p, r, h in zip(port, ref, host):
            assert set(p) == set(r) == set(h)
            for k in h:
                a = p[k].numpy()
                assert a.dtype == h[k].dtype, k
                np.testing.assert_array_equal(a, h[k], err_msg=k)
                np.testing.assert_array_equal(a, np.asarray(jax.device_get(r[k])), err_msg=k)


def test_degraded_sample_is_zero(cache):
    """Out-of-range clip spans degrade to the reserved zero frame."""
    meta = DeviceClipDataset(cache, train=True, clip_shape=HW, depth=32)
    s = meta[0]  # 24-frame videos cannot carry a 32-frame clip
    assert np.all(s["frame_idx"] == 0) and int(s["label_vid"]) == 0
    data, seg = assemble_clips_on_device(
        cache.pool_video, cache.pool_mask, s["frame_idx"][None], np.asarray([s["crop_y"]]),
        np.asarray([s["crop_x"]]), s["valid"][None], HW)
    assert not data.any() and not seg.any()


def test_batcher_over_meta_datasets(cache):
    b = _meta_batcher(cache)
    batches = list(b.epoch(0))
    assert len(batches) == b.steps_per_epoch()
    for batch in batches:
        assert batch["frame_idx"].shape == (4, 8) and batch["frame_idx"].dtype == np.int32
        assert batch["valid"].shape == (4, 8) and batch["row_mask"].shape == (4,)


def test_budget_enforced():
    with pytest.raises(ValueError, match="budget"):
        DeviceVideoCache.build(make_source(), budget_bytes=1 << 20, device="cpu")


def test_assembler_refuses_pools_on_another_device(cache):
    pools = {"pool_video": cache.pool_video.to("meta"), "pool_mask": cache.pool_mask}
    with pytest.raises(ValueError, match="lies on"):
        make_assembler_put(pools, HW, device="cpu")


def test_train_step_on_cache_batch_equals_host_batch(cache):
    """The device-cache flow (metadata batcher -> assembler on the
    prefetch thread -> the train step) gives the host streaming step's
    losses and gradients: the batches are the same bits."""
    hw = (80, 80)
    put = make_assembler_put({"pool_video": cache.pool_video, "pool_mask": cache.pool_mask},
                             hw, device="cpu")
    batches = {
        "cache": next(iter(PrefetchLoader(_meta_batcher(cache, hw=hw, bs=2).epoch(0),
                                          put_fn=put, device="cpu"))),
        "host": next(iter(PrefetchLoader(_host_batcher(hw, bs=2).epoch(0), device="cpu"))),
    }
    assert batches["cache"]["data"].dtype == torch.uint8
    assert batches["cache"]["loc_msk"].shape == (2, 8, 80, 80, 1)
    out = {}
    for name, batch in batches.items():
        state = create_train_state(seed=0, device="cpu", compute_dtype=torch.float32,
                                   bn_groups=2, dropout_rate=0.0)
        step = make_train_step(LossConfig(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11),
                               device="cpu")
        state, metrics = step(state, batch, 12.0, 0.5)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad for n, p in state.model.named_parameters()})
    assert all(np.isfinite(v) for v in out["cache"][0].values())
    assert out["cache"][0] == out["host"][0]
    for n, g in out["host"][1].items():
        assert torch.equal(out["cache"][1][n], g), n


def test_assembler_ands_the_per_frame_validity(cache):
    """With the JHMDB validity rule (with_validity) the assembled loc_msk
    is the host sample's: frames whose span index is not annotated carry
    no mask."""
    kw = dict(train=True, clip_shape=HW, seed=4, with_validity=True)
    host = ClipDataset(make_source(), device_prep=True, **kw)
    meta = DeviceClipDataset(cache, **kw)
    put = make_assembler_put({"pool_video": cache.pool_video, "pool_mask": cache.pool_mask},
                             HW, device="cpu")
    invalid = 0
    for i in range(len(host)):
        m = {k: np.asarray(v)[None] for k, v in meta[i].items()}
        out = put(m)
        hs = host[i]
        np.testing.assert_array_equal(out["loc_msk"][0].numpy(), hs["loc_msk"])
        invalid += int((m["valid"] == 0).sum())
        assert not out["loc_msk"][0][m["valid"][0] == 0].any()
    assert invalid > 0
