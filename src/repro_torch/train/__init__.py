from repro_torch.train import checkpoint
from repro_torch.train.trainer import History, RunConfig, make_mask, train

__all__ = ["checkpoint", "History", "RunConfig", "make_mask", "train"]
