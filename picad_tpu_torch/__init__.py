"""picad_tpu_torch — the PyTorch/CUDA port of picad_tpu.

A second package beside the JAX one (`picad_tpu/`), which stays the
reference the port is tested against.  This package imports torch and
numpy only: never jax, flax or anything from picad_tpu.

Layout mirrors the JAX package so each module's counterpart is easy to
find: `ops/` (convolution primitives, EM routing, the fused decoder head
and its hand-written CUDA kernel under `csrc/`), `models/` (I3D encoder,
capsule head, CapsNet), `eval/`, `serve/`, `checkpoint/`.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); with no card and no explicit device they raise rather
than fall back (see `_device.resolve_device`).  Importing the package has
no side effects: kernels are compiled at their first launch.
"""

__version__ = "0.1.0"
