"""train of the PyTorch/CUDA port (counterpart of picad_tpu/train)."""
