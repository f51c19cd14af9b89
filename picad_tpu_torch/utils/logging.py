"""Scalar metric logging: stdout + JSONL + (optional) TensorBoard and wandb.

Counterpart of picad_tpu/utils/logging.py.  The reference logs scalars
through tensorboardX every `--pf` batches (main_ucf101.py:202-214) and
wandb on JHMDB (main_jhmdb.py:204-210).  One MetricLogger fans out to an
append-only `metrics.jsonl` (the machine-readable run history) and, each
only where it imports, to TensorBoard (torch.utils.tensorboard) and
wandb.  The caller prints to stdout, through `print0`.

Inside a process group only rank 0 prints and logs: every rank's
metrics are the global batch's, and one file per run is enough.  The
JAX package's logger has no such gate (each host writes its own);
ROADMAP.md section 3 records the divergence.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Mapping

import torch

from picad_tpu_torch.parallel import mesh


def print0(*args, **kwargs) -> None:
    """print on rank 0 (or without a process group); nothing elsewhere."""
    if mesh.is_main():
        print(*args, **kwargs)


class MetricLogger:
    def __init__(
        self,
        log_dir: str,
        *,
        use_tensorboard: bool = True,
        use_wandb: bool = False,
        run_name: str | None = None,
        wandb_project: str = "picad_tpu",
    ):
        self.log_dir = log_dir
        self._jsonl = self._tb = self._wandb = None
        if not mesh.is_main():  # rank 0 logs for the run
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard: the JSONL file still logs
                pass
            else:
                self._tb = SummaryWriter(log_dir)
        if use_wandb:
            try:
                import wandb

                # derived run name like the reference's wandb bring-up
                # (main_jhmdb.py:413-422: wandb.init + run.name = exp id)
                wandb.init(
                    project=wandb_project,
                    name=run_name or os.path.basename(log_dir.rstrip("/")),
                    dir=log_dir,
                )
                self._wandb = wandb
            except Exception as e:  # absent, offline or refused: the JSONL file still logs
                print(f"MetricLogger: wandb disabled ({type(e).__name__}: {e})")

    def watch_params(self, named_tensors: Iterable[tuple[str, torch.Tensor]], step: int,
                     prefix: str = "params") -> None:
        """Per-tensor L2 norms of `named_tensors` (a module's
        `named_parameters()`) to every sink: the functional counterpart of
        the reference's `wandb.watch(model)` (main_jhmdb.py:422).  The
        norms are computed where the tensors lie and read in one copy."""
        if self._jsonl is None:
            return
        names, norms = [], []
        for name, t in named_tensors:
            names.append(f"{prefix}/{name.replace('.', '/')}")
            norms.append(torch.linalg.vector_norm(t.detach().float()))
        values = torch.stack(norms).cpu().tolist() if norms else []
        self.log(f"{prefix}_norms", dict(zip(names, values)), step)

    def log(self, tag: str, scalars: Mapping[str, float], step: int) -> None:
        if self._jsonl is None:
            return
        record = {"tag": tag, "step": step, "time": time.time(), **{
            k: float(v) for k, v in scalars.items()
        }}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in scalars.items()}, step)
        if self._wandb is not None:
            self._wandb.log({f"{tag}/{k}": float(v) for k, v in scalars.items()})

    def close(self) -> None:
        if self._jsonl is None:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception as e:  # a failed upload at the end loses no local record
                print(f"MetricLogger: wandb.finish failed ({type(e).__name__}: {e})")
