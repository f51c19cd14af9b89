"""Host-side batching + asynchronous device prefetch.

Counterpart of picad_tpu/data/loader.py, which replaces the reference's
torch DataLoader(num_workers=8) pair (main_ucf101.py:353-374) with:

- `SemiSupervisedBatcher`: per-epoch iterator yielding concatenated
  labeled+unlabeled batches.  Epoch length = number of unlabeled batches;
  the labeled stream cycles (main_ucf101.py:169-178).  The reference's
  in-batch randperm shuffle (main_ucf101.py:73-79) happens here on the
  host — it runs *before* the forward, so shuffling at batch-assembly
  time is mathematically identical (it exists to mix labeled/unlabeled
  rows within BN batch statistics).  Same batches as the JAX package's,
  bit for bit, for one seed.
- `PrefetchLoader`: a producer thread moves batches to the device ahead
  of use, so the copy of batch i + 1 overlaps step i: on a CUDA device
  through pinned staging slots and non-blocking copies on a side stream.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device


def _rank_and_world_size() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collate(samples: Sequence[dict]) -> dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples])
    return out


class SemiSupervisedBatcher:
    """Yields shuffled labeled+unlabeled batches, one epoch at a time."""

    def __init__(
        self,
        labeled_dataset,
        unlabeled_dataset,
        *,
        batch_size: int,
        seed: int = 0,
        workers: int = 4,
        force_stream_flags: bool = False,
        process_index: int | None = None,
        process_count: int | None = None,
        drop_last: bool = False,
    ):
        """batch_size is the PER-PROCESS batch.  With several processes
        each draws a disjoint strided shard of both datasets
        (process_index/process_count default to torch.distributed's rank
        and world size when it is initialized, else to 0/1)."""
        if batch_size % 2:
            raise ValueError("batch is split half labeled / half unlabeled")
        self.labeled = labeled_dataset
        self.unlabeled = unlabeled_dataset
        self.half = batch_size // 2
        self.seed = seed
        self.workers = workers
        if process_index is None or process_count is None:
            process_index, process_count = _rank_and_world_size()
        self.process_index = process_index
        self.process_count = process_count
        # UCF101 reads labeled_vid from ann[5]; JHMDB has no flag and the
        # reference training script forces ones/zeros per stream (main_jhmdb.py:66-70).
        self.force_stream_flags = force_stream_flags
        # drop_last=False matches the reference DataLoader default
        # (main_ucf101.py:353-374): the final partial unlabeled batch is
        # kept, zero-padded to the fixed batch size, and flagged via
        # the per-row `row_mask` so padded rows drop out of every loss.
        self.drop_last = drop_last
        self._spec = None

    def _acquire_buffers(self) -> dict[str, np.ndarray]:
        """Freshly allocated per-batch arrays for the fill_into path.

        Allocation is cheap; the win of fill_into is skipping the
        per-sample dicts + collate stack + whole-batch permute COPIES,
        not the allocation.  Buffers are deliberately NOT pooled: a
        caller may hold yielded batches (the tests keep whole epochs),
        so no yielded batch may alias another.  PrefetchLoader stages
        each batch into its own pinned slots for the copy to the card."""
        if self._spec is None:
            spec = self.unlabeled.batch_spec()
            if spec != self.labeled.batch_spec():
                raise ValueError("labeled and unlabeled datasets differ in batch_spec")
            self._spec = spec
        bs = 2 * self.half
        return {
            k: np.empty((bs, *shape), dtype)
            for k, (shape, dtype) in self._spec.items()
        }

    def _host_shard(self, order: np.ndarray) -> np.ndarray:
        """Strided per-process shard of a shuffled index order."""
        if self.process_count <= 1:
            return order
        return order[self.process_index :: self.process_count]

    def steps_per_epoch(self) -> int:
        """Identical on every process (collectives would deadlock on a
        per-process step count): computed from the LARGEST strided shard
        (drop_last=False) / the smallest (drop_last=True); short shards
        zero-pad their tail batches via row_mask."""
        n, c = len(self.unlabeled), max(self.process_count, 1)
        if self.drop_last:
            return max((n // c) // self.half, 1)
        longest = -(-n // c)  # ceil: process 0's shard
        return max(-(-longest // self.half), 1)

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        # the permutation seed is process-independent: every host shuffles
        # identically, then takes its strided shard (disjoint coverage)
        rng = np.random.default_rng((self.seed, epoch))
        for ds in (self.labeled, self.unlabeled):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

        unlabeled_order = self._host_shard(rng.permutation(len(self.unlabeled)))
        labeled_order = self._host_shard(rng.permutation(len(self.labeled)))
        labeled_pos = 0

        def next_labeled_indices(n):
            nonlocal labeled_pos, labeled_order
            out = []
            while len(out) < n:
                if labeled_pos >= len(labeled_order):
                    labeled_order = self._host_shard(
                        rng.permutation(len(self.labeled))
                    )
                    labeled_pos = 0
                out.append(int(labeled_order[labeled_pos]))
                labeled_pos += 1
            return out

        steps = self.steps_per_epoch()
        # Fast path: datasets expose fill_into (device_prep uint8 layout)
        # -> assemble each permuted row DIRECTLY into a reusable batch
        # buffer (native GIL-releasing crop-gather), skipping per-sample
        # dicts, collate-stack and the whole-batch permute copy.  Bit-
        # identical batches to the slow path (tests/test_loader.py); the
        # slow path remains for the reference float layout.
        fast = getattr(self.labeled, "supports_fill", False) and getattr(
            self.unlabeled, "supports_fill", False
        )
        if fast:
            bs = 2 * self.half
            for step in range(steps):
                u_idx = unlabeled_order[step * self.half : (step + 1) * self.half]
                l_idx = next_labeled_indices(self.half)
                n_real = len(l_idx) + len(u_idx)
                perm = rng.permutation(bs)
                bufs = self._acquire_buffers()
                data, loc = bufs["data"], bufs["loc_msk"]
                mask_cls = bufs.get("mask_cls")
                action = np.zeros((bs,), np.int32)
                label_vid = np.zeros((bs,), np.int32)
                row_mask = np.zeros((bs,), np.float32)
                for i in range(bs):
                    j = int(perm[i])
                    mc = mask_cls[i] if mask_cls is not None else None
                    if j < len(l_idx):
                        a, lv = self.labeled.fill_into(
                            l_idx[j], data[i], loc[i], mc
                        )
                        if self.force_stream_flags:
                            lv = 1
                    elif j < n_real:
                        a, lv = self.unlabeled.fill_into(
                            int(u_idx[j - self.half]), data[i], loc[i], mc
                        )
                        if self.force_stream_flags:
                            lv = 0
                    else:  # zero pad of the ragged final batch
                        data[i][...] = 0
                        loc[i][...] = 0
                        if mc is not None:
                            mc[...] = 0.0
                        a, lv = 0, 0
                    action[i] = a
                    label_vid[i] = lv
                    row_mask[i] = 1.0 if j < n_real else 0.0
                batch = {
                    "data": data,
                    "loc_msk": loc,
                    "action": action,
                    "label_vid": label_vid,
                }
                if mask_cls is not None:
                    batch["mask_cls"] = mask_cls
                batch["row_mask"] = row_mask
                yield batch
            return

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for step in range(steps):
                u_idx = unlabeled_order[step * self.half : (step + 1) * self.half]
                l_idx = next_labeled_indices(self.half)
                l_samples = list(pool.map(self.labeled.__getitem__, l_idx))
                u_samples = list(pool.map(self.unlabeled.__getitem__, u_idx))
                if self.force_stream_flags:
                    for s in l_samples:
                        s["label_vid"] = np.int32(1)
                    for s in u_samples:
                        s["label_vid"] = np.int32(0)
                n_real = len(l_samples) + len(u_samples)
                template = (u_samples or l_samples)[0]
                while len(u_samples) < self.half:  # ragged final batch
                    u_samples.append(
                        {k: np.zeros_like(v) for k, v in template.items()}
                    )
                batch = collate(l_samples + u_samples)
                nrows = len(l_samples) + len(u_samples)  # == 2 * self.half
                row_mask = np.zeros((nrows,), np.float32)
                row_mask[:n_real] = 1.0
                batch["row_mask"] = row_mask
                perm = rng.permutation(nrows)
                yield {k: v[perm] for k, v in batch.items()}


class _PinnedStager:
    """Copies numpy batches to a CUDA device through pinned host slots,
    non-blocking on the current (side) stream.  Slot k is refilled only
    after the event recorded behind its last copy has completed."""

    def __init__(self, device: torch.device, n_slots: int):
        self.device = device
        self.slots: list[dict] = [{} for _ in range(n_slots)]
        self.events: list[torch.cuda.Event | None] = [None] * n_slots
        self.next = 0

    def __call__(self, batch: dict) -> dict:
        k = self.next
        self.next = (k + 1) % len(self.slots)
        if self.events[k] is not None:
            self.events[k].synchronize()
        slot, out = self.slots[k], {}
        for name, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[name] = v.to(self.device, non_blocking=True)
                continue
            src = torch.from_numpy(np.ascontiguousarray(v))
            buf = slot.get(name)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = slot[name] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            out[name] = buf.to(self.device, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return out


def _to_cpu_tensors(batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()}


class PrefetchLoader:
    """Wraps a batch iterator; moves batches to `device` (default: the
    CUDA card) ahead of use.

    A producer thread takes each batch, applies `transform`, and places
    it with `put_fn` or, by default, copies its arrays to the device (on
    a CUDA device through `_PinnedStager`).  On a CUDA device the
    producer runs on a side stream and records an event behind each
    batch; the consumer's stream waits on that event before the batch is
    yielded, and every CUDA tensor of the batch is recorded on the
    consumer's stream, so the caching allocator does not hand its memory
    back to the side stream while the step still reads it.  `put_fn`
    (e.g. `device_cache.make_assembler_put`) runs under the same rules.
    At most `prefetch` batches wait in the queue.  An exception in the
    producer is raised in the consumer; closing the iterator stops the
    producer and joins its thread."""

    def __init__(
        self,
        batch_iterator: Iterator[dict],
        *,
        device=None,
        prefetch: int = 2,
        transform: Callable[[dict], Any] | None = None,
        put_fn: Callable[[dict], Any] | None = None,
    ):
        self.iterator = batch_iterator
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.transform = transform
        self.put_fn = put_fn

    def __iter__(self):
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(device=self.device) if cuda else None
        put = self.put_fn
        if put is None:
            put = _PinnedStager(self.device, self.prefetch + 1) if cuda else _to_cpu_tensors
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def hand_over(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                    for batch in self.iterator:
                        if self.transform is not None:
                            batch = self.transform(batch)
                        batch = put(batch)
                        event = None
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(side)
                        if not hand_over((batch, event)):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                hand_over(e)
                return
            hand_over(done)

        thread = threading.Thread(target=producer, name="PrefetchLoader", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(stream)
                yield batch
        finally:
            stop.set()
            thread.join()
