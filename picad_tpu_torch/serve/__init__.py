"""Serving: the in-process ServingModel, and the export and load of the
eval forward as an artifact (counterpart of picad_tpu/serve)."""

from picad_tpu_torch.serve.export import export_eval_forward, load_artifact, save_artifact
from picad_tpu_torch.serve.runner import ServingModel

__all__ = ["ServingModel", "export_eval_forward", "load_artifact", "save_artifact"]
