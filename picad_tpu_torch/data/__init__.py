"""Input pipeline: video sources, clip sampling, batching, device prefetch
and the card-resident video cache (counterpart of picad_tpu/data/)."""

from picad_tpu_torch.data.sources import (
    JHMDBVideoSource,
    SyntheticVideoSource,
    UCFVideoSource,
    rasterize_boxes,
)
from picad_tpu_torch.data.dataset import ClipDataset, EvalVideoDataset
from picad_tpu_torch.data.loader import PrefetchLoader, SemiSupervisedBatcher
