"""Typed configuration for training and evaluation.

The port's copy of picad_tpu/config.py: the same dataclasses, fields and
defaults, so a run command (cli/) builds the same configuration in both
packages.  One dataclass tree replaces the reference's two near-duplicate
argparse parsers (main_ucf101.py:283-318, main_jhmdb.py:281-312) and its
hard-coded dataset paths (ucf_dataloader.py:39,61;
jhmdb_dataloader.py:38-39).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DataConfig:
    dataset: str = "ucf101"  # 'ucf101' | 'jhmdb' | 'synthetic'
    data_root: str = ""  # directory containing videos
    mask_root: str = ""  # JHMDB puppet-mask root
    annotation_root: str = ""  # pickles / txt lists directory
    pkl_file_label: str = "train_annots_20_labeled.pkl"
    pkl_file_unlabel: str = "train_annots_80_unlabeled.pkl"
    test_file: str = "test_annots.pkl"
    clip_height: int = 224
    clip_width: int = 224
    depth: int = 8  # frames per clip
    vskip: int = 2  # temporal stride when sampling
    workers: int = 8  # host decode threads
    prefetch: int = 2  # batches on the card kept in flight
    # Pre-decoded .npy video cache (write-through): first touch decodes +
    # saves, later touches memmap and read only the sampled frames.
    # Empty = decode every sample like the reference (ucf_dataloader.py:197).
    decoded_cache_dir: str = ""
    # In-memory LRU over decoded VideoRecords (bytes; 0 = off).
    video_cache_bytes: int = 0
    # Ship cropped uint8 and normalize + flip on the card inside the step
    # (the same f32 numerics, ~8x fewer host->card bytes).  False is the
    # reference's float sample dict.
    device_prep: bool = True
    # Card-resident decoded-video cache (bytes; 0 = off): the train
    # streams' videos are uploaded once and each step ships only clip
    # METADATA, which the loader assembles into pixel batches on the card
    # (data/device_cache.py).  Falls back to host streaming when the pool
    # exceeds the budget.
    device_cache_bytes: int = 0
    # JHMDB pixel channel order: 'reference' = raw cv2 BGR exactly like
    # the reference loaders (they never convert, jhmdb_dataloader.py:
    # 238-246); 'rgb' converts.  UCF is always RGB (skvideo order).
    channel_order: str = "reference"
    # UCF decode stack: 'cv2' (built-in) or 'skvideo' (the reference's
    # skvideo.io.vread path; optional scikit-video dependency).
    decoder: str = "cv2"
    # synthetic backend (hermetic tests and benchmarks)
    synthetic_num_videos: int = 64
    synthetic_video_len: int = 40


@dataclasses.dataclass
class ModelConfig:
    num_classes: int = 24  # 24 UCF101-24 / 21 JHMDB-21
    pose_size: int = 4
    routing_iters: int = 3  # CapsNet's class capsules route 3 times; nothing else is built
    dropout_rate: float = 0.5
    compute_dtype: str = "bfloat16"  # conv compute; f32 accumulate
    pretrained_i3d: str = ""  # path to rgb_charades.pt (torch)
    remat_encoder: bool = False  # recompute the I3D activations in the backward


@dataclasses.dataclass
class OptimConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    adam_eps: float = 1e-6
    # ReduceLROnPlateau (main_ucf101.py:417)
    plateau_patience: int = 5
    plateau_factor: float = 0.1
    plateau_min_lr: float = 1e-7
    plateau_threshold: float = 1e-4


@dataclasses.dataclass
class LossConfig:
    loc_loss: str = "dice"  # 'dice' | 'iou'
    const_loss: str = "l2"  # 'l2' (jsd/l1 behave as l2, like the reference)
    wt_loc: float = 1.0
    wt_cls: float = 1.0
    wt_cons: float = 0.1
    # temporal-variance mask (--bv)
    bv: bool = False
    n_frames: int = 3  # variance window (3 or 5), NOT clip length
    predict_maps: bool = False  # sigmoid before the variance mask
    bv_wt: float = 0.5
    # gradient mask (--gv)
    gv: bool = False
    lower_thresh: Optional[float] = None
    upper_thresh: Optional[float] = None
    gv_wt: float = 0.5
    thresh_epoch: int = 11  # pseudo-label switch-on epoch
    spread_m_min: float = 0.2
    spread_m_max: float = 0.9


@dataclasses.dataclass
class ParallelConfig:
    # data parallelism: one rank per card (parallel/mesh.py)
    mesh_axis: str = "data"
    num_devices: int = 0  # 0 = all visible


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class TrainConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    bs: int = 16  # total batch (half labeled, half unlabeled)
    epochs: int = 1
    seed: int = 47
    pf: int = 50  # print/log frequency in steps
    exp_id: str = "debug"
    save_root: str = "train_log_wts"
    # reference deletes superseded best checkpoints only while e < 20
    # (main_ucf101.py:444-455)
    keep_all_after_epoch: int = 20
    # Fold original+flipped clips into one 2B-batch forward.  BatchNorm
    # computes per-view statistics (bn_groups=2), so the numerics are
    # those of the reference's two sequential forwards.
    fold_flip: bool = True
    log_every_host_transfer: bool = False
    # Trace a few warm train steps of the first epoch run into this
    # directory with torch.profiler ('' = off).
    profile_dir: str = ""

    def validate(self) -> None:
        """Fail fast on bad flags, before any model is built."""
        if self.bs % 2 != 0:
            raise ConfigError(
                f"--bs must be even (half labeled / half unlabeled), got {self.bs}"
            )
        if self.loss.loc_loss not in ("dice", "iou"):
            raise ConfigError(
                f"--loc_loss must be 'dice' or 'iou', got {self.loss.loc_loss!r}"
            )
        if self.loss.const_loss not in ("l2", "jsd", "l1"):
            raise ConfigError(
                f"--const_loss must be l2/jsd/l1, got {self.loss.const_loss!r}"
            )
        if self.loss.n_frames not in (3, 5):
            raise ConfigError(
                f"--n_frames (variance window) must be 3 or 5, got {self.loss.n_frames}"
            )
        if self.model.compute_dtype not in ("bfloat16", "float32"):
            raise ConfigError(
                f"--compute_dtype must be bfloat16/float32, got "
                f"{self.model.compute_dtype!r}"
            )
        if self.data.clip_height % 16 or self.data.clip_width % 16:
            raise ConfigError(
                "clip height/width must be divisible by 16 (I3D stride stack)"
            )
        if self.data.channel_order not in ("reference", "rgb"):
            raise ConfigError(
                f"--channel_order must be reference/rgb, got "
                f"{self.data.channel_order!r}"
            )
        if self.data.decoder not in ("cv2", "skvideo"):
            raise ConfigError(
                f"--decoder must be cv2/skvideo, got {self.data.decoder!r}"
            )
        if self.model.routing_iters != 3:  # kept for parity; refused, not ignored
            raise ConfigError(
                f"routing_iters: CapsNet routes 3 times, got {self.model.routing_iters}"
            )


@dataclasses.dataclass
class EvalConfig:
    ckpt_dir: str = ""
    split: str = "train"  # checkpoint-name filter (best_model_<split>*)
    num_classes: int = 24
    clip_batch_size: int = 14
    seed: int = 47
    prune: bool = True  # delete all but best-fmAP/best-vmAP checkpoints
