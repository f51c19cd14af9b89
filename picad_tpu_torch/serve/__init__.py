"""serve of the PyTorch/CUDA port (counterpart of picad_tpu/serve)."""
