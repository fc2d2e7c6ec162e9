from repro_torch.models.execution import ExecConfig, DEFAULT_EXEC
from repro_torch.models.model import Model, build_model

__all__ = ["ExecConfig", "DEFAULT_EXEC", "Model", "build_model"]
