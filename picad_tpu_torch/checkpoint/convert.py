"""Weights across the two packages, in the reference state-dict format.

The port's parameter names ARE the reference keys, so a reference-format
state dict (a reference `.pth`, or tests/sd_fixtures.py) loads directly.
`from_jax_variables` inverts the JAX package's converter
(picad_tpu/checkpoint/torch_convert.py): it takes a flax
{"params", "batch_stats"} tree as numpy and returns the reference-key
state dict, so both packages can run on the same weights.  The key
mapping is this module's own copy (the port imports nothing of
picad_tpu), limited to what this slice builds: I3D to Mixed_4f,
PrimaryCaps, ConvCaps and the decoder.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_I3D_CONVS = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")
_I3D_MIXED = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
              "Mixed_4e", "Mixed_4f")
_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")

# JAX layout -> torch layout (inverse of torch_convert.py:59-72, :148)
_TO_TORCH = {
    "conv3d": lambda w: w.transpose(4, 3, 0, 1, 2),  # (D,H,W,I,O) -> (O,I,D,H,W)
    "conv2d": lambda w: w.transpose(3, 2, 0, 1),  # (H,W,I,O) -> (O,I,H,W)
    "convt3d": lambda w: w.transpose(3, 4, 0, 1, 2),  # (D,H,W,I,O) -> (I,O,D,H,W)
    "convt2d": lambda w: w.transpose(2, 3, 0, 1),  # (H,W,I,O) -> (I,O,H,W)
    "caps_w": lambda w: w[None],  # (B,C,P,P) -> (1,B,C,P,P)
    "vec": lambda w: w,
}


def _unit3d_rows(torch_prefix: str, jax_path: tuple[str, ...]):
    return [
        (f"{torch_prefix}.conv3d.weight", "conv3d", ("params", *jax_path, "kernel")),
        (f"{torch_prefix}.bn.weight", "vec", ("params", *jax_path, "bn", "scale")),
        (f"{torch_prefix}.bn.bias", "vec", ("params", *jax_path, "bn", "bias")),
        (f"{torch_prefix}.bn.running_mean", "vec", ("batch_stats", *jax_path, "bn", "mean")),
        (f"{torch_prefix}.bn.running_var", "vec", ("batch_stats", *jax_path, "bn", "var")),
    ]


def capsnet_key_mapping() -> list[tuple[str, str, tuple[str, ...]]]:
    """(reference key, layout kind, flax path) for every tensor the
    port's CapsNet holds."""
    rows = []
    for ep in _I3D_CONVS:
        rows += _unit3d_rows(f"conv1.{ep}", ("conv1", ep))
    for ep in _I3D_MIXED:
        for br in _BRANCHES:
            rows += _unit3d_rows(f"conv1.{ep}.{br}", ("conv1", ep, br))
    rows += [
        ("primary_caps.pose.weight", "conv2d", ("params", "primary_caps", "pose_kernel")),
        ("primary_caps.pose.bias", "vec", ("params", "primary_caps", "pose_bias")),
        ("primary_caps.a.weight", "conv2d", ("params", "primary_caps", "a_kernel")),
        ("primary_caps.a.bias", "vec", ("params", "primary_caps", "a_bias")),
        ("conv_caps.beta_u", "vec", ("params", "conv_caps", "beta_u")),
        ("conv_caps.beta_a", "vec", ("params", "conv_caps", "beta_a")),
        ("conv_caps.weights", "caps_w", ("params", "conv_caps", "weights")),
    ]
    for name, kind in (("upsample1", "convt2d"), ("upsample2", "convt3d"),
                       ("upsample3", "convt3d"), ("upsample4", "convt3d"),
                       ("smooth", "convt3d"), ("conv28", "conv2d"),
                       ("conv56", "conv3d"), ("conv112", "conv3d")):
        rows += [
            (f"{name}.weight", kind, ("params", f"{name}_kernel")),
            (f"{name}.bias", "vec", ("params", f"{name}_bias")),
        ]
    return rows


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """flax {"params", "batch_stats"} tree (numpy leaves) -> reference-key
    state dict of f32 numpy arrays.  Raises KeyError on a missing leaf."""
    sd = {}
    for key, kind, path in capsnet_key_mapping():
        node = variables
        for p in path:
            node = node[p]
        sd[key] = np.ascontiguousarray(
            _TO_TORCH[kind](np.asarray(node, dtype=np.float32))
        )
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> list[str]:
    """Load a reference-format state dict (numpy arrays or tensors) into
    `model`, strictly on the keys the model holds: a missing key or a
    shape mismatch raises.  Keys the model does not hold (a full I3D's
    Mixed_5b/5c, `num_batches_tracked`) are skipped and returned."""
    own = model.state_dict()
    tensors = {
        k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        for k, v in sd.items()
        if k in own
    }
    model.load_state_dict(tensors, strict=True)
    return sorted(k for k in sd if k not in own)
