"""Whole-train-state checkpoints + the reference's best-loss retention policy.

Counterpart of picad_tpu/checkpoint/manager.py.  The reference saves a
bare state_dict whenever the train or val loss improves and deletes the
previously best file only while epoch < 20 (main_ucf101.py:439-455); it
saves no optimizer state and has no resume.  The policy is kept; each
checkpoint holds the whole train state, so a run resumes exactly:

- the model (parameters and BN running stats);
- the optimizer's state_dict (Adam's moments and step counts);
- the dropout generator's state;
- `step` and `epoch`;
- the three ReduceLROnPlateau counters and the live learning rate, so a
  resumed run reduces the LR at the epoch an unbroken run would.

A checkpoint is a directory `best_model_{tag}_loss_{epoch}` (the JAX
package's names) holding one `torch.save` file, read back with
`weights_only=True`.

Inside a process group (picad_tpu/checkpoint/manager.py:28-45, :74-80)
every rank calls `save`, and rank 0 alone writes, between two barriers;
the file also holds every rank's dropout generator (`rank_generators`),
so a resume at the same world size continues each rank's stream.  Every
rank restores from the file onto its own device, and only rank 0
deletes a superseded checkpoint.
"""

from __future__ import annotations

import os
import shutil

import torch

from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.train.state import TrainState

STATE_FILE = "train_state.pt"


class CheckpointIO:
    """Saves and restores a TrainState as `<dir>/train_state.pt`."""

    def save(self, path: str, state: TrainState) -> int:
        """Write the state into directory `path` (replacing one that is
        there); returns the file's bytes.  Every rank of a process group
        calls it; rank 0 writes (the others return 0)."""
        path = os.path.abspath(path)
        generators = mesh.gather_objects(state.generator.get_state())
        mesh.barrier()
        if not mesh.is_main():
            mesh.barrier()  # rank 0 has written the file
            return 0
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "step": int(state.step),
            "epoch": int(state.epoch),
            "sched_best": float(state.sched_best),
            "sched_bad": int(state.sched_bad),
            "sched_cooldown": int(state.sched_cooldown),
            "lr": state.learning_rate(),
        }
        if len(generators) > 1:
            payload["rank_generators"] = generators
        file = os.path.join(path, STATE_FILE)
        torch.save(payload, file)
        mesh.barrier()
        return os.path.getsize(file)

    @staticmethod
    def load(path: str) -> dict:
        """The saved payload, every tensor on the CPU."""
        return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, path: str, state: TrainState) -> TrainState:
        """Load the checkpoint in `path` into `state` (in place, onto the
        state's device) and return it."""
        ckpt = self.load(path)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        gens = ckpt.get("rank_generators", [ckpt["generator"]])
        if len(gens) == mesh.world_size():
            state.generator.set_state(gens[mesh.rank()])
        else:  # another world size: each rank keeps its fresh (seed, rank) stream
            if mesh.is_main():
                print(f"{path}: saved by {len(gens)} ranks, restored on "
                      f"{mesh.world_size()}; the dropout streams start afresh")
        state.step, state.epoch = ckpt["step"], ckpt["epoch"]
        state.sched_best = ckpt["sched_best"]
        state.sched_bad, state.sched_cooldown = ckpt["sched_bad"], ckpt["sched_cooldown"]
        return state.with_learning_rate(ckpt["lr"])

    @staticmethod
    def load_model(path: str) -> dict:
        """Only the checkpoint's model state (the eval sweep), memory-mapped:
        the optimizer's moments in the same file are not read."""
        return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                          mmap=True, weights_only=True)["model"]


class BestCheckpointPolicy:
    """best-val / best-train retention matching main_ucf101.py:429-455."""

    def __init__(self, save_dir: str, tag: str, keep_all_after_epoch: int = 20):
        self.save_dir = save_dir
        self.tag = tag  # 'val' or 'train'
        self.keep_all_after_epoch = keep_all_after_epoch
        self.best_loss = float("inf")
        self.prev_path: str | None = None
        self.io = CheckpointIO()

    def maybe_save(self, epoch: int, loss: float, state) -> str | None:
        if loss >= self.best_loss:
            return None
        self.best_loss = loss
        path = os.path.join(self.save_dir, f"best_model_{self.tag}_loss_{epoch}")
        self.io.save(path, state)
        if self.prev_path and epoch < self.keep_all_after_epoch and mesh.is_main():
            shutil.rmtree(self.prev_path, ignore_errors=True)
        self.prev_path = path
        return path
