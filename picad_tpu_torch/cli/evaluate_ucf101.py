"""UCF101-24 evaluation CLI (evaluate_ucf101.py equivalent).

Counterpart of picad_tpu/cli/evaluate_ucf101.py, with the same flags;
sweeps the checkpoints on the CUDA card:

  python -m picad_tpu_torch.cli.evaluate_ucf101 --ckpt DIR \
      --data_root /data/ucf101 --annotation_root /data/pkls

The eval model is f32, as the JAX CLI's CapsNet(num_classes=24) is
(picad_tpu/models/capsules.py:256).
"""

from __future__ import annotations

import argparse
import os

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.data.dataset import EvalVideoDataset
from picad_tpu_torch.data.sources import SyntheticVideoSource, UCFVideoSource
from picad_tpu_torch.eval.runner import sweep_checkpoints


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluation")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--annotation_root", type=str, default="")
    p.add_argument(
        "--test_file", type=str, default="testing_annots.pkl",
        help="eval annotation pickle (the reference EVAL loader reads "
        "testing_annots.pkl, ucf_dataloader_eval.py; the near-identically "
        "named test_annots.pkl is the TRAIN-val split, main_ucf101.py:347)",
    )
    p.add_argument("--clip_batch_size", type=int, default=14)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--no_prune", action="store_true")
    p.add_argument(
        "--decoder", type=str, default="cv2", choices=("cv2", "skvideo"),
        help="video decode stack: 'skvideo' reproduces the reference's "
        "skvideo.io.vread/ffmpeg path (ucf_dataloader_eval.py:116; needs "
        "the optional scikit-video package), 'cv2' is the built-in "
        "OpenCV path (pixels usually identical, not provably so)",
    )
    p.add_argument(
        "--nan_safe", action="store_true",
        help="mean over present classes only (reference np.mean propagates "
        "NaN when a class has no test videos, evaluate_ucf101.py:184-187)",
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
        source = SyntheticVideoSource(8, num_classes=24, seed=args.seed)
    else:
        # The per-video single-annotation choice is drawn from the legacy
        # MT19937 stream seeded by --seed in dataset order — the exact
        # draws of np.random.seed(47) (evaluate_ucf101.py:36) +
        # np.random.randint (ucf_dataloader_eval.py:135-137) with
        # num_workers=0 (see PARITY.md for the num_workers>0 caveat).
        source = UCFVideoSource(
            os.path.join(args.annotation_root, args.test_file),
            args.data_root,
            single_annotation=True,
            annotation_seed=args.seed,
            decoder=args.decoder,
        )
    return sweep_checkpoints(
        args.ckpt,
        EvalVideoDataset(source),
        split=args.split,
        n_classes=24,
        clip_batch_size=args.clip_batch_size,
        prune=not args.no_prune,
        nan_safe=args.nan_safe,
        device=dev,
        eval_dp=args.eval_dp,
        eval_devices=eval_devices,
    )


if __name__ == "__main__":
    main()
