"""Epoch-level training orchestration.

Counterpart of picad_tpu/train/loop.py, which mirrors the reference
training script (main_ucf101.py:321-456): three datasets (labeled / unlabeled /
validation), CapsNet + losses, Adam + ReduceLROnPlateau(train loss), the
exp ramp-up of the consistency weight, per-epoch validation with mean
binary-mask IoU (NaN-filtered like main_ucf101.py:261-266), and
best-val / best-train checkpointing with the e<20 deletion rule.

On the card the loop keeps the step free of host synchronisations: each
step's metrics stay on the device, and the host reads them only at the
`pf` boundaries and at the epoch's end, as the JAX loop does
(picad_tpu/train/loop.py:236-262).  Each epoch gets its own
PrefetchLoader, closed when the epoch ends, so no producer thread or
pinned slot outlives it.  Checkpoints hold the whole train state
(checkpoint/manager.py), which adds the resume the reference lacks.

Inside a process group (parallel/mesh.py; the train CLIs start one rank
per card) the Trainer is one rank of a data-parallel run: its batcher
draws the rank's strided shard at `cfg.bs` / `cfg.parallel.num_devices`
rows (a host's batch over its ranks), the step's losses, metrics and
BN statistics are the global batch's, validation runs the rank's strided
shard of the validation set in lockstep, and rank 0 alone prints, logs
and writes checkpoints, into one `save_dir` that it chose.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.checkpoint.manager import BestCheckpointPolicy
from picad_tpu_torch.config import TrainConfig
from picad_tpu_torch.data.loader import PrefetchLoader, SemiSupervisedBatcher, collate
from picad_tpu_torch.eval.metrics import binary_mask_iou
from picad_tpu_torch.objectives.ramp_ups import exp_rampup
from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.train.optimizer import ReduceLROnPlateau
from picad_tpu_torch.train.state import broadcast_model, create_train_state
from picad_tpu_torch.train.step import make_train_step, make_val_step
from picad_tpu_torch.utils.logging import MetricLogger, print0
from picad_tpu_torch.utils.profiling import StepTimer, trace_context

I3D_TENSORS = 45 * 5  # a Mixed_4f-truncated I3D: 45 Unit3Ds x (conv kernel + 4 BN tensors)
PROFILE_STEPS = (3, 8)  # --profile_dir: warm steps [3, 8) of the first epoch run

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _read_metrics(pending: list[dict]) -> list[dict]:
    """Device metric dicts -> host dicts of floats, in one copy."""
    if not pending:
        return []
    keys = list(pending[0])
    host = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending])
    return [dict(zip(keys, row)) for row in host.cpu().double().tolist()]


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        *,
        labeled_dataset,
        unlabeled_dataset,
        val_dataset=None,
        use_wandb: bool = False,
        watch: bool = False,
        device=None,
    ):
        """The train state, step and loaders of `cfg` on `device`
        (default: the CUDA card; the CPU only when asked)."""
        self.cfg = cfg
        cfg.validate()  # fail fast before any model is built
        self.device = dev = resolve_device(device)
        self.world = mesh.world_size()
        self.rank_bs = self._rank_batch(cfg)
        self.state = create_train_state(
            seed=cfg.seed,
            device=dev,
            lr=cfg.optim.lr,
            eps=cfg.optim.adam_eps,
            weight_decay=cfg.optim.weight_decay,
            num_classes=cfg.model.num_classes,
            pose_size=cfg.model.pose_size,
            compute_dtype=_DTYPES[cfg.model.compute_dtype],
            dropout_rate=cfg.model.dropout_rate,
            bn_groups=2 if cfg.fold_flip else 1,
            remat_encoder=cfg.model.remat_encoder,
        )
        if cfg.model.pretrained_i3d:
            self._load_pretrained_i3d(cfg.model.pretrained_i3d)
        broadcast_model(self.state)  # the ranks start from rank 0's weights

        # Card-resident video cache (data/device_cache.py): the datasets
        # carry `.cache`, batches are clip metadata, and the loader's
        # producer assembles them into pixel batches on the card, so the
        # train step is the same as on the streaming path.
        cache = getattr(labeled_dataset, "cache", None)
        self._assemble_put = None
        if cache is not None:
            from picad_tpu_torch.data.device_cache import make_assembler_put

            pools = {"pool_video": cache.pool_video, "pool_mask": cache.pool_mask}
            self._assemble_put = make_assembler_put(
                pools, (cfg.data.clip_height, cfg.data.clip_width), device=dev)
        # --watch: the reference's wandb.watch(model) (main_jhmdb.py:422)
        # = a grad_norm scalar from the step and parameter norms every pf
        # batches (MetricLogger.watch_params)
        self._watch = watch
        self.train_step = make_train_step(cfg.loss, device=dev, grad_metrics=watch)
        self.val_step = make_val_step(cfg.loss, device=dev)

        self.batcher = SemiSupervisedBatcher(
            labeled_dataset,
            unlabeled_dataset,
            batch_size=self.rank_bs,
            seed=cfg.seed,
            process_index=mesh.rank(),
            process_count=self.world,
            workers=cfg.data.workers,
            force_stream_flags=cfg.data.dataset == "jhmdb",
        )
        self.val_dataset = val_dataset
        self.ramp = exp_rampup(cfg.epochs)
        self.scheduler = ReduceLROnPlateau(
            cfg.optim.lr,
            factor=cfg.optim.plateau_factor,
            patience=cfg.optim.plateau_patience,
            min_lr=cfg.optim.plateau_min_lr,
            threshold=cfg.optim.plateau_threshold,
        )
        self._profiled = False
        self.epoch_stats: list[dict] = []  # each epoch run: wall, clips/s, mean loss

        # rank 0's stamp: the ranks' clocks can straddle a minute
        save_dir = mesh.broadcast_object(
            os.path.join(cfg.save_root, cfg.exp_id, time.strftime("%m-%d-%H-%M")))
        if mesh.is_main():
            os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        # derived run name like the reference (main_jhmdb.py:413-415)
        self.logger = MetricLogger(
            save_dir, use_wandb=use_wandb,
            run_name=f"{cfg.exp_id}_{cfg.data.dataset}_bs{cfg.bs}",
        )
        self.best_val = BestCheckpointPolicy(save_dir, "val", cfg.keep_all_after_epoch)
        self.best_train = BestCheckpointPolicy(save_dir, "train", cfg.keep_all_after_epoch)

    def _rank_batch(self, cfg: TrainConfig) -> int:
        """This rank's rows a step: the host batch over its ranks."""
        if not mesh.is_active():
            if cfg.parallel.num_devices > 1:
                raise ValueError(
                    f"--num_devices {cfg.parallel.num_devices}: a Trainer is one rank; start "
                    "the ranks with cli.common.train_main (parallel.mesh.launch)")
            return cfg.bs
        n = cfg.parallel.num_devices
        if n < 1 or self.world % n:
            raise ValueError(f"cfg.parallel.num_devices={n}: set it to the ranks a host "
                             f"runs, a divisor of the world size {self.world}")
        return mesh.check_rank_batch(cfg.bs, n)

    def _load_pretrained_i3d(self, path: str) -> None:
        """Load a reference-format I3D state dict (rgb_charades.pt: keys
        `Conv3d_1a_7x7.conv3d.weight`, ...) by key into the encoder.  A
        wrong path or an incompatible file must not silently fall back to
        training from scratch, so fewer than 225 matched tensors raise
        (picad_tpu/train/loop.py:170-205)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        own = self.state.model.conv1.state_dict()
        matched = {k: v for k, v in sd.items() if k in own}
        n = len(matched)
        if n == 0:
            raise ValueError(
                f"pretrained I3D checkpoint {path!r} yielded 0 matching "
                "tensors — wrong file or incompatible state_dict")
        if n < I3D_TENSORS:
            raise ValueError(
                f"pretrained I3D checkpoint {path!r} yielded only {n} tensors "
                f"(expected {I3D_TENSORS} = 45 Unit3Ds x [conv kernel + 4 BN "
                "tensors] for a Mixed_4f-truncated I3D)")
        with torch.no_grad():
            for k, v in matched.items():
                if own[k].shape != v.shape:
                    raise ValueError(f"pretrained I3D tensor {k}: {tuple(v.shape)}, "
                                     f"the model's is {tuple(own[k].shape)}")
                own[k].copy_(v)
        print0(f"Loaded I3D pretrained weights from {path} for {n} tensors")

    # ---- epochs ----

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        wt_ramp = self.ramp(epoch)
        loader = PrefetchLoader(self.batcher.epoch(epoch), device=self.device,
                                prefetch=cfg.data.prefetch, put_fn=self._assemble_put)
        steps = self.batcher.steps_per_epoch()
        global_bs = self.rank_bs * self.world
        timer = StepTimer(clips_per_step=global_bs, n_chips=self.world)
        pending: list[dict] = []  # device metrics not yet read
        running: list[dict] = []  # host metrics of the epoch's steps so far
        t0 = time.time()
        profiling = bool(cfg.profile_dir) and not self._profiled and mesh.is_main()
        self._profiled = True
        trace = None
        it = iter(loader)
        try:
            for batch_id, batch in enumerate(it):
                if profiling and batch_id == PROFILE_STEPS[0]:
                    trace = trace_context(cfg.profile_dir)
                    trace.__enter__()
                self.state, metrics = self.train_step(self.state, batch, float(epoch), wt_ramp)
                pending.append(metrics)
                if trace is not None and batch_id == PROFILE_STEPS[1] - 1:
                    trace = self._end_trace(trace)
                timer.tick()
                if (batch_id + 1) % cfg.pf == 0:
                    running += _read_metrics(pending)
                    pending = []
                    self._log_train(epoch, batch_id, steps, running, timer)
        finally:
            if trace is not None:  # the epoch was shorter than the window
                self._end_trace(trace)
            it.close()  # stops and joins the loader's producer thread
        running += _read_metrics(pending)
        wall = time.time() - t0
        print0("Training time: ", wall)
        mean_loss = float(np.mean([m["loss"] for m in running])) if running else float("inf")
        self.epoch_stats.append({"epoch": epoch, "steps": len(running), "seconds": wall,
                                 "clips_per_s": len(running) * global_bs / wall,
                                 "loss": mean_loss})
        return mean_loss

    def _end_trace(self, trace) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.__exit__(None, None, None)
        print0(f"Profiler trace written to {self.cfg.profile_dir}")

    def _log_train(self, epoch, batch_id, steps, running, timer) -> None:
        cfg = self.cfg
        host = {k: float(np.mean([m[k] for m in running])) for k in running[0]}
        tput = timer.report()
        print0(
            f"[TRAIN] epoch-{epoch}/{cfg.epochs}, "
            f"batch-{batch_id + 1}/{steps}, "
            f"loss-{host['loss']:.3f}, acc-{host['acc']:.3f}\t"
            f"[LOSS] cls-{host['loss_cls']:.3f}, "
            f"seg-{host['loss_seg']:.3f}, "
            f"const-{host['loss_consistency']:.3f}  "
            f"({tput['clips_per_sec']:.1f} clips/s)",
            flush=True,
        )
        total_step = (epoch - 1) * steps + batch_id + 1
        self.logger.log("train/loss", {
            k: host[k] for k in ("loss", "loss_seg", "loss_cls", "loss_consistency")
        }, total_step)
        self.logger.log("train/acc", {"acc": host["acc"]}, total_step)
        if self._watch:
            self.logger.log("train/grad", {"grad_norm": host["grad_norm"]}, total_step)
            self.logger.watch_params(self.state.model.named_parameters(), total_step)

    def validate(self, epoch: int) -> float:
        if self.val_dataset is None:
            return float("inf")
        cfg = self.cfg
        totals, accs = [], []
        total_iou, valid_iou = 0.0, 0
        t0 = time.time()
        n = len(self.val_dataset)
        bs = self.rank_bs
        # Each rank validates its strided shard; the val step reduces the
        # losses and accuracy over the global batch (row-masked), so they
        # come back identical on every rank, and the ranks run the same
        # number of steps, a short shard padding with all-pad batches
        # (picad_tpu/train/loop.py:289-331).
        r, world = mesh.rank(), self.world
        mine = list(range(r, n, world))
        steps = mesh.steps_lockstep(n, world, bs)
        # decode (cv2/ffmpeg) releases the GIL, so the fetches of a batch
        # overlap each other and the running val step
        with ThreadPoolExecutor(max_workers=max(cfg.data.workers, 1)) as pool:
            for s in range(steps):
                idx = mine[s * bs:(s + 1) * bs]
                samples = list(pool.map(self.val_dataset.__getitem__, idx))
                n_real = len(samples)
                if n_real == 0:  # a short shard or an empty set: one all-pad batch
                    samples = [self.val_dataset.zero_sample()]
                while len(samples) < bs:  # zero-pad the ragged final batch
                    samples.append({k: np.zeros_like(v) for k, v in samples[0].items()})
                batch = collate(samples)
                row_mask = np.zeros((bs,), np.float32)
                row_mask[:n_real] = 1.0
                gt_np = batch["loc_msk"][..., 0]  # host copy before the move
                batch["row_mask"] = row_mask
                batch = mesh.put_global_batch(batch, self.device)
                seg_bin, metrics = self.val_step(self.state, batch, batch["row_mask"])
                totals.append(metrics["loss"])
                accs.append(metrics["acc"])
                seg_np = seg_bin.cpu().numpy()
                for a in range(n_real):  # the IoU of this rank's own rows
                    iou = binary_mask_iou(gt_np[a], seg_np[a])
                    if iou == iou:
                        total_iou += iou
                        valid_iou += 1
        print0("Validation time: ", time.time() - t0)
        total_iou, valid_iou = mesh.all_reduce_floats([total_iou, valid_iou], self.device)
        avg_iou = total_iou / max(valid_iou, 1)
        val_loss = float(np.mean(torch.stack(totals).double().cpu().numpy()))
        val_acc = float(np.mean(torch.stack(accs).double().cpu().numpy()))
        print0(
            f"[VAL] epoch-{epoch}, loss-{val_loss:.3f}, "
            f"acc-{val_acc:.3f} [IOU ] {avg_iou:.3f}",
            flush=True,
        )
        self.logger.log("val", {"loss": val_loss, "acc": val_acc, "iou": avg_iou}, epoch)
        return val_loss

    def restore(self, path: str) -> int:
        """Resume from a whole-train-state checkpoint (the reference has
        no resume: its .pth files hold bare params, main_ucf101.py:
        439-455).  Returns the next epoch to run."""
        self.best_val.io.restore(path, self.state)
        # the counters and live LR come back from the state, so a resumed
        # run reduces the LR at the SAME epoch an unbroken run would
        self.state.load_scheduler(self.scheduler)
        next_epoch = self.state.epoch + 1
        print0(f"Resumed from {path} at epoch {next_epoch}")
        return next_epoch

    def fit(self, start_epoch: int = 1) -> None:
        epochs = range(start_epoch, self.cfg.epochs + 1)
        try:
            from tqdm import tqdm

            epochs = tqdm(epochs, disable=not mesh.is_main())
        except ImportError:
            pass
        try:
            for e in epochs:
                train_loss = self.train_epoch(e)
                val_loss = self.validate(e)
                # Scheduler BEFORE checkpointing (the reference steps after
                # saving, main_ucf101.py:456, but its .pth holds no
                # scheduler; stepping first makes the saved state the exact
                # point an unbroken run passes through, so a resume never
                # loses a plateau step).  Only the LR and the counters change.
                new_lr = self.scheduler.step(train_loss)
                if abs(new_lr - self.state.learning_rate()) > 1e-6 * new_lr:
                    self.state.with_learning_rate(new_lr)
                    print0(f"ReduceLROnPlateau: lr -> {new_lr:.2e}")
                self.state.epoch = e
                self.state.with_scheduler(self.scheduler)
                if self.best_val.maybe_save(e, val_loss, self.state):
                    print0("Yay!!! Got the val loss down...")
                if self.best_train.maybe_save(e, train_loss, self.state):
                    print0("Yay!!! Got the train loss down...")
        finally:
            self.logger.close()
