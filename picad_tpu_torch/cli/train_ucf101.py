"""UCF101-24 semi-supervised training CLI.

Counterpart of picad_tpu/cli/train_ucf101.py; usage mirrors the
reference (README.md:9-17) and trains on the CUDA card:

  python -m picad_tpu_torch.cli.train_ucf101 --epochs 100 --bs 8 --loc_loss dice \
      --lr 1e-4 --wt_loc 1 --wt_cls 1 --wt_cons 0.1 --const_loss l2 \
      --bv --n_frames 5 --thresh_epoch 11 \
      --data_root /data/ucf101 --annotation_root /data/pkls

Replaces main_ucf101.py:321-456.
"""

from __future__ import annotations

from picad_tpu_torch.cli.common import train_main


def main(argv=None, *, device=None, devices=None):
    """Train on `device` (default: the CUDA card; the CPU only when asked).
    With several ranks they go on `devices` when given (see
    `cli.common.train_main`)."""
    return train_main("ucf101", argv, device=device, devices=devices)


if __name__ == "__main__":
    main()
