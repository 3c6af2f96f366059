from repro_torch.train.trainer import History, RunConfig, make_mask, train

__all__ = ["History", "RunConfig", "make_mask", "train"]
