"""Shared CLI plumbing: argparse -> TrainConfig, dataset construction.

Counterpart of picad_tpu/cli/common.py, with the same flags, defaults
and `args_to_config` mapping, so a run command moves between the two
packages unchanged.  Flag names follow the reference parsers
(main_ucf101.py:283-318, main_jhmdb.py:281-312), plus the path flags the
reference hard-coded (--data_root, --annotation_root, --mask_root) and
the JAX package's own (--compute_dtype, --no_fold_flip, --num_devices,
--synthetic, ...).

Data parallelism (parallel/mesh.py): `--num_devices N` (0 = every
visible card) starts N ranks on the host, one process per card, each
taking `--bs`/N rows of the host's batch; `--num_processes P
--process_id p --coordinator host:port` joins P hosts into one process
group of P*N ranks, whose global batch is `--bs` x P, as in the JAX
package.  One rank on one host (the default on a one-card machine)
creates no process group and runs the one-card path.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import torch

from picad_tpu_torch.config import TrainConfig
from picad_tpu_torch.parallel import mesh


def build_parser(dataset: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"picad_tpu_torch {dataset} training")
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--model_name", type=str, default="i3d")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--pf", type=int, default=50)
    p.add_argument("--pretrained", type=str, default="i3d")
    p.add_argument("--pretrained_i3d_path", type=str, default="")
    if dataset == "ucf101":
        p.add_argument("--loc_loss", type=str, default="dice")
        p.add_argument("--wt_loc", type=float, default=1.0)
        p.add_argument(
            "--pkl_file_label", type=str, default="train_annots_20_labeled.pkl"
        )
        p.add_argument(
            "--pkl_file_unlabel", type=str, default="train_annots_80_unlabeled.pkl"
        )
    else:
        p.add_argument("--seg_loss", type=str, default="dice")
        p.add_argument("--wt_seg", type=float, default=1.0)
        p.add_argument(
            "--pkl_file_label",
            type=str,
            default="jhmdb_classes_list_per_20_labeled.txt",
        )
        p.add_argument(
            "--pkl_file_unlabel",
            type=str,
            default="jhmdb_classes_list_per_80_unlabeled.txt",
        )
    p.add_argument("--exp_id", type=str, default="debug")
    p.add_argument("--const_loss", type=str, default="l2")
    p.add_argument("--wt_cls", type=float, default=1.0)
    p.add_argument("--wt_cons", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("--thresh_epoch", type=int, default=11)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--n_frames", type=int, default=3)
    p.add_argument("--bv", action="store_true")
    p.add_argument("--predict_maps", action="store_true")
    p.add_argument("--bv_wt", type=float, default=0.5)
    p.add_argument("--cyclic", action="store_true",
                   help="accepted and ignored, like the reference: "
                   "main_ucf101.py:310 defines --cyclic but no code "
                   "reads it (the cyclic 14-frame construction is always "
                   "on inside the --bv variance mask)")
    p.add_argument("--gv", action="store_true")
    p.add_argument("--lower_thresh", type=float, default=None)
    p.add_argument("--upper_thresh", type=float, default=None)
    p.add_argument("--gv_wt", type=float, default=0.5)
    if dataset != "ucf101":
        p.add_argument(
            "--channel_order", type=str, default="reference",
            choices=("reference", "rgb"),
            help="JHMDB pixel channel order: 'reference' = raw cv2 BGR "
            "exactly like the reference's loaders (they never cvtColor, "
            "jhmdb_dataloader.py:238-246), 'rgb' converts (matches the "
            "RGB statistics of the rgb_charades.pt I3D pretrain)",
        )
    p.add_argument(
        "--decoder", type=str, default="cv2", choices=("cv2", "skvideo"),
        help="UCF video decode stack ('skvideo' = the reference's "
        "skvideo.io.vread path, needs the optional scikit-video package)",
    )
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--mask_root", type=str, default="")
    p.add_argument("--annotation_root", type=str, default="")
    p.add_argument("--save_root", type=str, default="train_log_wts")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--no_fold_flip", action="store_true",
                   help="run original/flipped views as two forwards")
    p.add_argument("--num_devices", type=int, default=0,
                   help="cards to train on, one rank each (0 = all visible); "
                   "each rank takes --bs / N rows")
    p.add_argument("--synthetic", action="store_true",
                   help="use the procedural data backend (hermetic runs)")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--watch", action="store_true",
                   help="log param-norm histograms + a grad_norm scalar "
                   "every --pf batches (the reference's wandb.watch, "
                   "main_jhmdb.py:422)")
    p.add_argument("--resume", type=str, default="",
                   help="path to a full-train-state checkpoint to resume from")
    p.add_argument("--decoded_cache_dir", type=str, default="",
                   help="write-through pre-decoded .npy video cache dir; "
                   "later epochs memmap instead of re-running ffmpeg")
    p.add_argument("--video_cache_gb", type=float, default=0.0,
                   help="in-memory LRU over decoded videos (GiB, 0 = off)")
    p.add_argument("--device_cache_gb", type=float, default=0.0,
                   help="card-resident decoded-video pool (GiB, 0 = off): "
                   "train steps receive clip metadata only and the loader "
                   "assembles the pixel batch on the card; falls back to "
                   "host streaming if the dataset exceeds the budget")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of train steps here")
    # multi-host launch: one process per host, each starting its ranks
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0's rendezvous (with --num_processes > 1)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    return p


def args_to_config(args, dataset: str) -> TrainConfig:
    cfg = TrainConfig()
    cfg.bs = args.bs
    cfg.epochs = args.epochs
    cfg.seed = args.seed
    cfg.pf = args.pf
    cfg.exp_id = args.exp_id
    cfg.save_root = args.save_root
    cfg.fold_flip = not args.no_fold_flip

    cfg.data.dataset = "synthetic" if args.synthetic else dataset
    cfg.data.data_root = args.data_root
    cfg.data.mask_root = args.mask_root
    cfg.data.annotation_root = args.annotation_root
    cfg.data.pkl_file_label = args.pkl_file_label
    cfg.data.pkl_file_unlabel = args.pkl_file_unlabel
    cfg.data.workers = args.workers
    cfg.data.decoded_cache_dir = args.decoded_cache_dir
    cfg.data.video_cache_bytes = int(args.video_cache_gb * (1 << 30))
    cfg.data.device_cache_bytes = int(args.device_cache_gb * (1 << 30))
    cfg.data.channel_order = getattr(args, "channel_order", "reference")
    cfg.data.decoder = args.decoder

    cfg.model.num_classes = 24 if dataset == "ucf101" else 21
    # Superseded-checkpoint deletion gate: the reference deletes earlier
    # best checkpoints while e<20 on UCF101 (main_ucf101.py:444,453) but
    # while e<4 on JHMDB (main_jhmdb.py:435,444).
    cfg.keep_all_after_epoch = 20 if dataset == "ucf101" else 4
    cfg.model.compute_dtype = args.compute_dtype
    cfg.model.pretrained_i3d = args.pretrained_i3d_path

    cfg.optim.lr = args.lr

    cfg.loss.loc_loss = getattr(args, "loc_loss", None) or getattr(
        args, "seg_loss", "dice"
    )
    cfg.loss.const_loss = args.const_loss
    cfg.loss.wt_loc = getattr(args, "wt_loc", None) or getattr(args, "wt_seg", 1.0)
    cfg.loss.wt_cls = args.wt_cls
    cfg.loss.wt_cons = args.wt_cons
    cfg.loss.bv = args.bv
    cfg.loss.n_frames = args.n_frames
    cfg.loss.predict_maps = args.predict_maps
    cfg.loss.bv_wt = args.bv_wt
    cfg.loss.gv = args.gv
    cfg.loss.lower_thresh = args.lower_thresh
    cfg.loss.upper_thresh = args.upper_thresh
    cfg.loss.gv_wt = args.gv_wt
    cfg.loss.thresh_epoch = args.thresh_epoch

    cfg.parallel.num_devices = args.num_devices
    cfg.profile_dir = args.profile_dir
    return cfg


def _hosts(args) -> int:
    """--num_processes (at least 1), with its companion flags checked."""
    hosts = max(args.num_processes, 1)
    if hosts > 1:
        if not args.coordinator:
            raise ValueError(f"--num_processes {hosts} needs --coordinator host:port")
        if not 0 <= args.process_id < hosts:
            raise ValueError(f"--process_id {args.process_id} is not in [0, {hosts})")
    return hosts


def maybe_initialize_distributed(args, *, local_rank: int = 0, devices: Sequence = ("cpu",),
                                 init_method: str | None = None) -> bool:
    """Join the process group as the host's rank `local_rank` on
    `devices[local_rank]`, one rank per entry of the host's `devices`:
    global rank process_id * len(devices) + local_rank of
    max(--num_processes, 1) * len(devices), at `init_method` (default:
    the --coordinator's), over `mesh.backend_for(devices)`.  One rank on
    one host joins nothing; returns whether a group was created.
    Multi-host flags are checked first."""
    hosts, n = _hosts(args), len(devices)
    if hosts * n == 1:
        return False
    pid = max(args.process_id, 0) if hosts > 1 else 0
    mesh.initialize_distributed(init_method or f"tcp://{args.coordinator}", hosts * n,
                                pid * n + local_rank, device=devices[local_rank],
                                backend=mesh.backend_for(devices))
    return True


def build_train_datasets(cfg: TrainConfig, *, device=None, multi_host: bool = False):
    """(labeled, unlabeled, validation) datasets for the config.  With
    `device_cache_bytes` the two train streams go into one
    DeviceVideoCache on `device` (default: the CUDA card): on one host
    every rank builds the whole cache on its own card, as the JAX package
    replicates its pools over the local mesh; a `multi_host` run streams
    (picad_tpu/cli/common.py:273-277)."""
    from picad_tpu_torch.data.dataset import ClipDataset
    from picad_tpu_torch.data.sources import (
        CachedVideoSource,
        JHMDBVideoSource,
        SyntheticVideoSource,
        UCFVideoSource,
    )

    d = cfg.data
    cache_dir = d.decoded_cache_dir or None

    def maybe_cache(src):
        if d.video_cache_bytes > 0:
            return CachedVideoSource(src, capacity_bytes=d.video_cache_bytes)
        return src

    if d.dataset == "synthetic":
        n = d.synthetic_num_videos
        ncls = cfg.model.num_classes
        lab = SyntheticVideoSource(n, num_classes=ncls, labeled_fraction=1.0, seed=1)
        unl = SyntheticVideoSource(n, num_classes=ncls, labeled_fraction=0.0, seed=2)
        val = SyntheticVideoSource(max(n // 4, 1), num_classes=ncls,
                                   labeled_fraction=1.0, seed=3)
        with_validity = False
    elif d.dataset == "ucf101":
        lab = UCFVideoSource(
            os.path.join(d.annotation_root, d.pkl_file_label), d.data_root,
            decoded_cache_dir=cache_dir, decoder=d.decoder,
        )
        unl = UCFVideoSource(
            os.path.join(d.annotation_root, d.pkl_file_unlabel), d.data_root,
            decoded_cache_dir=cache_dir, decoder=d.decoder,
        )
        val = UCFVideoSource(
            os.path.join(d.annotation_root, d.test_file), d.data_root,
            decoded_cache_dir=cache_dir, decoder=d.decoder,
        )
        with_validity = False
    elif d.dataset == "jhmdb":
        lab = JHMDBVideoSource(
            os.path.join(d.annotation_root, d.pkl_file_label), d.data_root,
            d.mask_root, decoded_cache_dir=cache_dir,
            channel_order=d.channel_order,
        )
        unl = JHMDBVideoSource(
            os.path.join(d.annotation_root, d.pkl_file_unlabel), d.data_root,
            d.mask_root, decoded_cache_dir=cache_dir,
            channel_order=d.channel_order,
        )
        val = JHMDBVideoSource(
            os.path.join(d.annotation_root, "testlist.txt"), d.data_root,
            d.mask_root, decoded_cache_dir=cache_dir,
            channel_order=d.channel_order,
        )
        with_validity = True
    else:
        raise ValueError(d.dataset)
    lab, unl, val = maybe_cache(lab), maybe_cache(unl), maybe_cache(val)

    shape = (d.clip_height, d.clip_width)

    def mk(src, train):
        return ClipDataset(src, train=train, clip_shape=shape, depth=d.depth, vskip=d.vskip,
                           with_validity=with_validity, seed=cfg.seed,
                           device_prep=d.device_prep)

    if d.device_cache_bytes > 0 and d.device_prep and multi_host:
        # the per-rank shard is re-drawn from a global shuffle every
        # epoch, so no fixed video subset fits one host's pool
        print("device video cache: multi-host run, using host streaming")
    elif d.device_cache_bytes > 0 and d.device_prep:
        from picad_tpu_torch.data.device_cache import DeviceClipDataset, DeviceVideoCache
        from picad_tpu_torch.data.sources import ConcatVideoSource

        try:
            cache = DeviceVideoCache.build(ConcatVideoSource([lab, unl]),
                                           budget_bytes=d.device_cache_bytes, device=device,
                                           workers=max(d.workers, 1))
        except ValueError as e:
            print(f"device video cache disabled ({e}); streaming instead")
        else:
            n_l = len(lab)

            def mkd(off, n):
                return DeviceClipDataset(cache, index_offset=off, length=n, train=True,
                                         clip_shape=shape, depth=d.depth, vskip=d.vskip,
                                         with_validity=with_validity, seed=cfg.seed)

            print(f"device video cache: {cache.pool_video.shape[0]} frames resident on "
                  f"{cache.pool_video.device}; steps receive clip metadata only")
            return mkd(0, n_l), mkd(n_l, len(unl)), mk(val, False)

    return mk(lab, True), mk(unl, True), mk(val, False)


def train_main(dataset: str, argv=None, *, device=None, devices=None):
    """The train CLIs' body (picad_tpu/cli/train_ucf101.py:23-40): parse,
    build the config and datasets, train on `device` (default: the CUDA
    card), resuming from `--resume`.  Returns the Trainer.

    With more than one rank (--num_devices, --num_processes) it starts
    the host's ranks (`parallel.mesh.launch`), rank i on cuda:i (or all
    on the CPU), or on `devices` when given (["cuda:0", "cuda:0"]: two
    ranks sharing one card, over gloo), waits for them and returns None;
    rank 0 prints, logs and writes the checkpoints."""
    from picad_tpu_torch._device import resolve_device

    args = build_parser(dataset).parse_args(argv)
    print(vars(args))
    dev = resolve_device(device)  # no card and no device: raise before any work
    cfg = args_to_config(args, dataset)
    devs = mesh.host_devices(cfg.parallel.num_devices, dev, devices)
    hosts, n = _hosts(args), len(devs)
    if n == 1 and hosts == 1:
        return _train(cfg, args, dev if devices is None else devs[0])
    mesh.check_rank_batch(cfg.bs, n)
    cfg.parallel.num_devices = n
    init = f"tcp://{args.coordinator}" if hosts > 1 else f"tcp://localhost:{mesh.free_port()}"
    # CPU ranks share the host's torch threads
    threads = max(torch.get_num_threads() // n, 1) if dev.type == "cpu" else 0
    mesh.launch(_train_rank, n, (cfg, args, devs, init, threads))
    return None


def _train_rank(local_rank, cfg, args, devices, init_method, threads):
    """One rank of `train_main`: join the group, train, leave; returns
    the rank's Trainer."""
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    maybe_initialize_distributed(args, local_rank=local_rank, devices=devices,
                                 init_method=init_method)
    try:
        return _train(cfg, args, devices[local_rank],
                      multi_host=max(args.num_processes, 1) > 1)
    finally:
        dist.destroy_process_group()


def _train(cfg, args, dev, multi_host: bool = False):
    from picad_tpu_torch.train.loop import Trainer
    from picad_tpu_torch.utils.logging import print0

    labeled, unlabeled, val = build_train_datasets(cfg, device=dev, multi_host=multi_host)
    print0(len(labeled), len(unlabeled), len(val))
    trainer = Trainer(
        cfg,
        labeled_dataset=labeled,
        unlabeled_dataset=unlabeled,
        val_dataset=val,
        use_wandb=args.wandb,
        watch=args.watch,
        device=dev,
    )
    start_epoch = trainer.restore(args.resume) if args.resume else 1
    trainer.fit(start_epoch)
    return trainer
