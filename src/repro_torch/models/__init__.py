from repro_torch.models import resnet, softmax

__all__ = ["resnet", "softmax"]
