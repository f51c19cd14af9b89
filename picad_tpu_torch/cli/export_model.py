"""Export a trained checkpoint as a serving artifact.

Counterpart of picad_tpu/cli/export_model.py, with its flags and
`--device` in place of `--platforms`:

  python -m picad_tpu_torch.cli.export_model --ckpt DIR/best_model_train_loss_N \
      --out /path/artifact [--hw 224] [--clip_batch_size 14] \
      [--compute_dtype bf16] [--device cuda] [--verify]

The checkpoint is one directory written by the port's CheckpointIO
(checkpoint/manager.py).  The artifact (model.pt2 + meta.json) loads
with `picad_tpu_torch.serve.load_artifact` on the device type it was
exported on, and needs the port's ops there but no model code, checkpoint
or training stack (serve/export.py).  `--verify` reloads the artifact
and holds 3 random clips against the live ServingModel at rtol 1e-4,
atol 1e-5, as the JAX CLI does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.checkpoint.manager import CheckpointIO
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.serve.export import load_artifact, save_artifact
from picad_tpu_torch.serve.runner import ServingModel

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="serving export")
    p.add_argument("--ckpt", type=str, required=True,
                   help="one checkpoint directory (not a sweep root)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--hw", type=int, default=224,
                   help="spatial eval resolution (reference: 224)")
    p.add_argument("--clip_batch_size", type=int, default=14)
    p.add_argument("--num_classes", type=int, default=24)
    p.add_argument("--compute_dtype", type=str, default="f32", choices=tuple(_DTYPES),
                   help="the artifact's compute type: bf16 is the card's serving "
                   "precision (weights stay f32 inside, convolutions cast, f32 "
                   "accumulation)")
    p.add_argument("--device", type=str, default=None,
                   help="device to trace on, and the only device type the artifact "
                   "runs on (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=47,
                   help="seed of --verify's random clips (every weight comes from "
                   "the checkpoint)")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and compare 3 random clips against "
                   "the live eval forward")
    return p


def main(argv=None) -> str:
    """Export --ckpt to --out on --device; returns the artifact path."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)  # no card and no --device: raise before any work
    model = build_capsnet(CheckpointIO.load_model(args.ckpt), num_classes=args.num_classes,
                          compute_dtype=_DTYPES[args.compute_dtype], device=dev)
    out = save_artifact(
        args.out, model, clip_batch_size=args.clip_batch_size, height=args.hw,
        width=args.hw, num_classes=args.num_classes,
        extra_meta={"source_checkpoint": args.ckpt},
    )
    print(f"Exported {args.ckpt} -> {out} (device={dev.type})")

    if args.verify:
        serving = load_artifact(out, device=dev)
        live = ServingModel.from_model(model, clip_batch_size=args.clip_batch_size,
                                       height=args.hw, width=args.hw)
        clips = np.random.default_rng(args.seed).random((3, 8, args.hw, args.hw, 3),
                                                        dtype=np.float32)
        seg_a, sc_a = serving.predict_clips(clips)
        seg_b, sc_b = live.predict_clips(clips)
        np.testing.assert_allclose(seg_a, seg_b, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sc_a, sc_b, rtol=1e-4, atol=1e-5)
        print("Verified: artifact matches the live eval forward.")
    return out


if __name__ == "__main__":
    main()
