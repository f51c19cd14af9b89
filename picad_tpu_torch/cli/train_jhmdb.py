"""JHMDB-21 semi-supervised training CLI (main_jhmdb.py equivalent).

Counterpart of picad_tpu/cli/train_jhmdb.py.  The reference JHMDB script
imports modules missing from its repo (main_jhmdb.py:338,369); this is
the working reconstruction: the same loop with num_classes=21, txt video
lists, puppet masks, per-stream labeled/unlabeled flags, and wandb
logging gated behind --wandb.
"""

from __future__ import annotations

from picad_tpu_torch.cli.common import train_main


def main(argv=None, *, device=None, devices=None):
    """Train on `device` (default: the CUDA card; the CPU only when asked).
    With several ranks they go on `devices` when given (see
    `cli.common.train_main`)."""
    return train_main("jhmdb", argv, device=device, devices=devices)


if __name__ == "__main__":
    main()
