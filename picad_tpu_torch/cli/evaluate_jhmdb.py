"""JHMDB-21 evaluation CLI (evaluate_jhmdb.py equivalent).

Counterpart of picad_tpu/cli/evaluate_jhmdb.py, with the same flags;
sweeps the checkpoints on the CUDA card with an f32 eval model.  Fixes
the reference's broken per-video logging (evaluate_jhmdb.py:144-147
writes to file handles that were never opened): pass --log_predictions
to write correct/incorrect video names to files in the checkpoint dir.
"""

from __future__ import annotations

import argparse
import os

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.data.dataset import EvalVideoDataset
from picad_tpu_torch.data.sources import JHMDBVideoSource, SyntheticVideoSource
from picad_tpu_torch.eval.runner import sweep_checkpoints


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluation")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("--split", type=str, default="")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--mask_root", type=str, default="")
    p.add_argument("--annotation_root", type=str, default="")
    p.add_argument("--test_file", type=str, default="testlist.txt")
    p.add_argument("--clip_batch_size", type=int, default=14)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no_prune", action="store_true")
    p.add_argument("--log_predictions", action="store_true")
    p.add_argument(
        "--channel_order", type=str, default="reference",
        choices=("reference", "rgb"),
        help="'reference' feeds raw cv2 BGR frames like the reference's "
        "JHMDB loaders (jhmdb_dataloader_eval.py:108-118 — reference "
        "checkpoints were trained on BGR); 'rgb' converts, for "
        "checkpoints trained with --channel_order rgb",
    )
    p.add_argument(
        "--nan_safe", action="store_true",
        help="mean over present classes only (reference np.mean propagates "
        "NaN when a class has no test videos, evaluate_jhmdb.py:180-183)",
    )
    p.add_argument(
        "--eval_dp", type=int, default=0,
        help="cards to split each clip batch over, one eval-model replica "
        "each (0/1 = one card); --clip_batch_size must divide evenly",
    )
    return p


def main(argv=None, *, device=None, eval_devices=None):
    """Sweep on `device` (default: the CUDA card; the CPU only when asked).
    With --eval_dp N the replicas go on `eval_devices` (default: cuda:0 ..
    cuda:N-1).  Returns {checkpoint path: summary}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)  # no card and no device: raise before any work
    if args.synthetic:
        source = SyntheticVideoSource(8, num_classes=21, seed=args.seed)
    else:
        # resize=None = the reference EVAL geometry: center-crop the RAW
        # 240x320 video and score against the unresized puppet masks
        # (jhmdb_dataloader_eval.py:83-140; the 256x256 resize is
        # train-only, jhmdb_dataloader.py:249-268).
        source = JHMDBVideoSource(
            os.path.join(args.annotation_root, args.test_file),
            args.data_root,
            args.mask_root,
            channel_order=args.channel_order,
            resize=None,
        )
    return sweep_checkpoints(
        args.ckpt,
        EvalVideoDataset(source, return_name=True),
        split=args.split,
        n_classes=21,
        clip_batch_size=args.clip_batch_size,
        prune=not args.no_prune,
        log_predictions=args.log_predictions,
        nan_safe=args.nan_safe,
        device=dev,
        eval_dp=args.eval_dp,
        eval_devices=eval_devices,
    )


if __name__ == "__main__":
    main()
