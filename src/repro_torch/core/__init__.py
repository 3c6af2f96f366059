from repro_torch.core import bits, channel, engine, operators, schedule

__all__ = ["bits", "channel", "engine", "operators", "schedule"]
