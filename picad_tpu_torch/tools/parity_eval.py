"""One-command reference-checkpoint evaluation-parity harness.

Counterpart of tools/parity_eval.py (runbook: PARITY.md), on the card:

  python -m picad_tpu_torch.tools.parity_eval \
      --reference_pth  trained_wts/best_model_train_loss_37.pth \
      --data_root      /data/ucf101 \
      --annotation_root /data/pkls \
      [--rgb_charades  /data/rgb_charades.pt] \
      [--reference_line "Accuracy: 0.87 IoU/fmap/vmap 0.2 0.71 0.69 0.5 0.52 0.50"] \
      [--tol 5e-4] [--eval_dp N] [--nan_safe]

On the same weights, the port's evaluation must print the f-mAP / v-mAP
numbers of the reference's evaluate_ucf101.py / evaluate_jhmdb.py.  It:

1. loads the reference `.pth` into the f32 CapsNet by its keys
   (checkpoint/convert.load_reference_state_dict; the port's parameter
   names are the reference keys), over an optional `--rgb_charades` I3D
   underlay (the reference's load order, capsules_ucf101.py:344-353, then
   load_previous_weights); a partial checkpoint without the underlay
   raises, since zero weights would give metrics that look like a parity
   miss;
2. runs the full-video protocol (eval/engine.evaluate_dataset), on one
   card or, with `--eval_dp N`, split over N replicas
   (eval/runner.make_sharded_forward);
3. prints the metrics in the reference's exact print() format
   (evaluate_ucf101.py:189 / evaluate_jhmdb.py:185);
4. with `--reference_line`, prints per-field deltas and PASS or FAIL at
   `--tol`; the exit code is 1 on FAIL.

JHMDB: `--dataset jhmdb --list_file testlist.txt --mask_root
/data/puppet_masks` (21 classes; the reference line has no
'IoU/fmap/vmap' token, both formats parse).  `--synthetic N` runs N
synthetic videos in place of real data (the plumbing check).
"""

from __future__ import annotations

import argparse
import copy
import os
import re
import sys

import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.checkpoint.convert import load_reference_state_dict

# Fields of the printout, in print order (threshold tokens excluded)
_FIELDS = ("accuracy", "fmAP@0.2", "vmAP@0.2", "fmAP@0.5", "vmAP@0.5")
_NUMBER = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference-checkpoint parity eval")
    p.add_argument("--reference_pth", required=True,
                   help="reference CapsNet .pth (full state_dict)")
    p.add_argument("--rgb_charades", default="",
                   help="optional I3D backbone .pt underlay, applied before the .pth "
                   "overlay (the reference's load order: capsules_ucf101.py:344-353 "
                   "then load_previous_weights)")
    p.add_argument("--dataset", choices=("ucf101", "jhmdb"), default="ucf101")
    p.add_argument("--data_root", default="")
    p.add_argument("--annotation_root", default="",
                   help="UCF101: directory holding the annotation pickles")
    p.add_argument("--test_file", default="testing_annots.pkl",
                   help="UCF101 eval pickle (ucf_dataloader_eval.py reads "
                   "testing_annots.pkl; test_annots.pkl is the TRAIN-val split, "
                   "main_ucf101.py:347)")
    p.add_argument("--list_file", default="", help="JHMDB: txt list of test videos")
    p.add_argument("--mask_root", default="", help="JHMDB: puppet_mask.mat root")
    p.add_argument("--clip_batch_size", type=int, default=14)
    p.add_argument("--seed", type=int, default=47,
                   help="single-annotation choice seed: the legacy MT19937 draws of "
                   "the reference at num_workers=0 (evaluate_ucf101.py:36, "
                   "ucf_dataloader_eval.py:135-137; PARITY.md)")
    p.add_argument("--decoder", choices=("cv2", "skvideo"), default="cv2",
                   help="UCF decode stack; 'skvideo' is the reference's "
                   "skvideo.io.vread path (needs scikit-video)")
    p.add_argument("--channel_order", choices=("reference", "rgb"), default="reference",
                   help="JHMDB channel order: 'reference' = raw cv2 BGR, what every "
                   "reference JHMDB checkpoint was trained on")
    p.add_argument("--reference_line", default="",
                   help="the line the REFERENCE eval printed for this checkpoint; "
                   "every field is diffed against it")
    p.add_argument("--tol", type=float, default=5e-4,
                   help="absolute tolerance per field for PASS (mAPs are ratios of "
                   "integer threshold-hit counts; the default absorbs print() "
                   "rounding in a pasted line)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic eval videos instead of real data")
    p.add_argument("--input_hw", type=int, default=224,
                   help="clip side length; 224 is the protocol")
    p.add_argument("--eval_dp", type=int, default=0,
                   help="split clip batches over N replicas (0/1 = one device)")
    p.add_argument("--nan_safe", action="store_true",
                   help="mean over present classes only; the default matches the "
                   "reference (np.mean propagates NaN when a class has no test "
                   "videos, evaluate_ucf101.py:184-187)")
    return p.parse_args(argv)


def parse_reference_line(line: str, dataset: str) -> dict[str, float]:
    """The 5 metric fields of a reference printout line.

    UCF101 (evaluate_ucf101.py:189):
      Accuracy: <acc> IoU/fmap/vmap 0.2 <f2> <v2> 0.5 <f5> <v5>
    JHMDB (evaluate_jhmdb.py:185): the same without 'IoU/fmap/vmap'.
    Both hold 7 numbers: [acc, 0.2, f2, v2, 0.5, f5, v5]."""
    floats = [float(t) for t in _NUMBER.findall(line)]
    if len(floats) != 7:
        raise ValueError(f"expected 7 numbers (acc, 0.2, f2, v2, 0.5, f5, v5) in the "
                         f"reference line, found {len(floats)}: {line!r}")
    acc, t2, f2, v2, t5, f5, v5 = floats
    if not (abs(t2 - 0.2) < 1e-9 and abs(t5 - 0.5) < 1e-9):
        raise ValueError(f"threshold tokens should be 0.2 and 0.5, got {t2} and {t5} — "
                         f"is this a {dataset} eval line?")
    return dict(zip(_FIELDS, (acc, f2, v2, f5, v5)))


def reference_format_line(summary: dict, dataset: str) -> str:
    """The reference's exact print() output for these numbers."""
    r = lambda k: repr(float(summary[k]))  # noqa: E731 (np.float64's repr is not a number)
    parts = ["Accuracy:", r("accuracy")]
    if dataset == "ucf101":
        parts.append("IoU/fmap/vmap")  # evaluate_ucf101.py:189 literal
    parts += ["0.2", r("fmAP@0.2"), r("vmAP@0.2"), "0.5", r("fmAP@0.5"), r("vmAP@0.5")]
    return " ".join(parts)


def _torch_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_state(args, model: torch.nn.Module) -> None:
    """Load the reference weights into `model` (the f32 CapsNet): zeros,
    under the optional --rgb_charades I3D underlay (keys without the
    `conv1.` prefix), under the --reference_pth overlay, then
    checkpoint/convert.load_reference_state_dict.  Keys the CapsNet does
    not hold (a full I3D's Mixed_5b/5c, `num_batches_tracked`) are
    dropped.  A checkpoint that covers fewer than all of the CapsNet's
    tensors raises unless --rgb_charades is given (picad_tpu's
    `load_variables`)."""
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    if args.rgb_charades:
        i3d = {f"conv1.{k}": v for k, v in _torch_state_dict(args.rgb_charades).items()}
        sd.update((k, v) for k, v in i3d.items() if k in sd)
        print(f"[parity] rgb_charades underlay: {sum(k in sd for k in i3d)} tensors",
              file=sys.stderr)
    ref = {k: v for k, v in _torch_state_dict(args.reference_pth).items() if k in sd}
    sd.update(ref)
    # 45 Unit3Ds x 5 + PrimaryCaps 4 + ConvCaps 3 + decoder 16
    if len(ref) < len(sd) and not args.rgb_charades:
        raise SystemExit(
            f"[parity] {args.reference_pth} holds only {len(ref)}/{len(sd)} of the "
            "CapsNet's tensors — a partial checkpoint needs --rgb_charades for the "
            "backbone, and parity only holds on FULL checkpoints")
    print(f"[parity] checkpoint overlay: {len(ref)} tensors", file=sys.stderr)
    load_reference_state_dict(model, sd)


def build_dataset(args):
    from picad_tpu_torch.data.dataset import EvalVideoDataset
    from picad_tpu_torch.data.sources import (
        JHMDBVideoSource,
        SyntheticVideoSource,
        UCFVideoSource,
    )

    n_classes = 24 if args.dataset == "ucf101" else 21
    if args.synthetic:
        src = SyntheticVideoSource(args.synthetic, num_classes=n_classes, seed=args.seed)
    elif args.dataset == "ucf101":
        src = UCFVideoSource(
            os.path.join(args.annotation_root, args.test_file), args.data_root,
            single_annotation=True, annotation_seed=args.seed, decoder=args.decoder,
        )
    else:
        if not args.list_file or not args.mask_root:
            raise SystemExit("[parity] --dataset jhmdb needs --list_file and --mask_root")
        # resize=None: the reference eval crops the RAW-resolution video and
        # scores against the unresized puppet masks (jhmdb_dataloader_eval.py:
        # 83-140), never the train loader's 256x256 geometry
        src = JHMDBVideoSource(args.list_file, args.data_root, args.mask_root,
                               channel_order=args.channel_order, resize=None)
    hw = (args.input_hw, args.input_hw)
    return EvalVideoDataset(src, clip_shape=hw), n_classes


def main(argv=None, *, device=None, eval_devices=None) -> int:
    """The harness on `device` (default: the CUDA card); with --eval_dp N
    the replicas go on `eval_devices` (default: cuda:0 .. cuda:N-1).
    Returns the exit code: 1 on FAIL, else 0."""
    args = parse_args(argv)
    dev = resolve_device(device)  # no card and no device: raise before any work

    from picad_tpu_torch.eval.engine import evaluate_dataset
    from picad_tpu_torch.eval.runner import (
        make_padded_forward,
        make_sharded_forward,
        replica_devices,
    )
    from picad_tpu_torch.models.capsules import CapsNet

    dataset, n_classes = build_dataset(args)
    replicas = replica_devices(args.eval_dp, dev, eval_devices)
    # f32 end to end: the parity configuration
    model = CapsNet(num_classes=n_classes, compute_dtype=torch.float32)
    load_state(args, model)
    models = [copy.deepcopy(model).to(d).eval() for d in replicas or [dev]]
    forward = (make_padded_forward(models[0], clip_batch_size=args.clip_batch_size)
               if replicas is None else
               make_sharded_forward(models, clip_batch_size=args.clip_batch_size))
    summary = evaluate_dataset(forward, dataset, n_classes=n_classes,
                               clip_batch_size=args.clip_batch_size, verbose=False,
                               nan_safe=args.nan_safe)
    print(reference_format_line(summary, args.dataset))

    if not args.reference_line:
        print("[parity] no --reference_line given; paste the reference eval's printout "
              "for this checkpoint to get a field-by-field diff", file=sys.stderr)
        return 0

    ref = parse_reference_line(args.reference_line, args.dataset)
    ok = True
    print(f"{'field':>10} {'reference':>12} {'ours':>12} {'delta':>12}")
    for field in _FIELDS:
        ours, theirs = float(summary[field]), ref[field]
        delta = ours - theirs
        flag = "" if abs(delta) <= args.tol else "  <-- MISMATCH"
        ok &= not flag
        print(f"{field:>10} {theirs:>12.6f} {ours:>12.6f} {delta:>+12.2e}{flag}")
    print(f"[parity] {'PASS' if ok else 'FAIL'} at tol={args.tol}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
