"""AOT export of the eval forward as a serving artifact.

Counterpart of picad_tpu/serve/export.py.  The eval-mode forward (the
call contract of eval/runner.make_eval_fn: f32 clips (cb, depth, H, W, 3)
-> (sigmoid seg, class scores); BatchNorm on running statistics, the pose
mask from the predicted argmax) is traced once with torch.export at a
fixed clip batch, with the weights inside, and saved next to a JSON
metadata sidecar.  It loads without the model code, the checkpoint
machinery or the training stack.

One deliberate divergence from the JAX package, whose artifacts trace
the pure-XLA chain and bake in no kernel (picad_tpu/serve/export.py:
14-19): here the kernels of the eval forward stay in the artifact as
named custom ops, `picad::composite_convt` (K1, the fused decoder head),
`picad::tap_conv_fwd` (K3, PrimaryCaps' two 9x9 convs) and
`picad::max_pool_axis` (a stage of the Inception blocks' stride-1 max
pools, csrc/max_pool_s1.cu; 16 a forward).  K1's and K3's plain versions
cost 5.8 and 14.8 ms a serving batch on the card against the kernels'
0.17 and 0.85 ms (PERF.md).  So loading an artifact needs the three op
modules (`picad_tpu_torch.ops`, imported by `load_artifact`), which run
the kernels on the card and the plain versions on the CPU.

An artifact is traced on one device type and runs on it only: the graph
holds constants (index tensors, zeros) made on that device.  Loading it
on another raises; nothing falls back.

Artifact layout (a directory):
    model.pt2    torch.export.save of the ExportedProgram
    meta.json    shapes, device, num_classes, compute type, format version
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from picad_tpu_torch._device import resolve_device

_FORMAT_VERSION = 1
_ARTIFACT_BIN = "model.pt2"
_ARTIFACT_META = "meta.json"
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


class _EvalForward(torch.nn.Module):
    """The eval call: clips -> (sigmoid seg, class scores)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, clips: torch.Tensor):
        seg, scores, _ = self.model(clips)
        return torch.sigmoid(seg), scores


def export_eval_forward(model: torch.nn.Module, *, clip_batch_size: int, height: int,
                        width: int, depth: int = 8) -> torch.export.ExportedProgram:
    """Trace the eval forward of `model` (put in eval mode) on its own
    device for a (clip_batch_size, depth, height, width, 3) f32 clip
    batch; returns the ExportedProgram (weights inside)."""
    model.eval()
    device = next(model.parameters()).device
    clips = torch.zeros((clip_batch_size, depth, height, width, 3), dtype=torch.float32,
                        device=device)
    with torch.no_grad():
        return torch.export.export(_EvalForward(model), (clips,), strict=False)


def save_artifact(out_dir: str, model: torch.nn.Module, *, clip_batch_size: int,
                  height: int, width: int, depth: int = 8, num_classes: int | None = None,
                  extra_meta: Mapping[str, Any] | None = None) -> str:
    """Export and write the artifact directory; returns its path."""
    ep = export_eval_forward(model, clip_batch_size=clip_batch_size, height=height,
                             width=width, depth=depth)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(out_dir, _ARTIFACT_BIN))
    dtype = getattr(model, "compute_dtype", torch.float32)
    meta = {
        "format_version": _FORMAT_VERSION,
        "clip_batch_size": clip_batch_size,
        "depth": depth,
        "height": height,
        "width": width,
        "device": next(model.parameters()).device.type,
        "num_classes": num_classes if num_classes is not None
        else getattr(model, "num_classes", None),
        "compute_dtype": _DTYPE_NAMES.get(dtype, str(dtype)),
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(dict(extra_meta))
    with open(os.path.join(out_dir, _ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return out_dir


def load_artifact(artifact_dir: str, device=None):
    """Load an artifact directory onto `device` (default: the CUDA card)
    -> ServingModel (serve/runner.py), with the loaded ExportedProgram as
    its `program`.  Raises on another format version, and on a device
    type other than the one the artifact was traced on."""
    # the custom ops' registrations, which the saved graph names
    import picad_tpu_torch.ops.convops  # noqa: F401
    import picad_tpu_torch.ops.fused_head_kernel  # noqa: F401
    import picad_tpu_torch.ops.tapconv  # noqa: F401
    from picad_tpu_torch.eval.runner import pad_to_batch
    from picad_tpu_torch.serve.runner import ServingModel

    dev = resolve_device(device)  # no card and no device: raise before any work
    with open(os.path.join(artifact_dir, _ARTIFACT_META)) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"artifact format {meta.get('format_version')!r} != supported "
                         f"{_FORMAT_VERSION} ({artifact_dir})")
    if dev.type != meta["device"]:
        raise ValueError(f"artifact {artifact_dir} was traced on {meta['device']!r} and "
                         f"runs there only, not on {str(dev)!r}")
    program = torch.export.load(os.path.join(artifact_dir, _ARTIFACT_BIN))
    module = program.module()

    def fwd(clips: torch.Tensor):
        with torch.inference_mode():
            return module(clips)

    serving = ServingModel(pad_to_batch(fwd, dev, clip_batch_size=int(meta["clip_batch_size"])),
                           meta)
    serving.program = program
    return serving
