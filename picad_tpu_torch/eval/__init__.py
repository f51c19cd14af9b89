"""eval of the PyTorch/CUDA port (counterpart of picad_tpu/eval)."""
