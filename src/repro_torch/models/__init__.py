from repro_torch.models import resnet, softmax
from repro_torch.models.api import get_model

__all__ = ["get_model", "resnet", "softmax"]
