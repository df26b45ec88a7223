"""Optimizers and learning-rate schedules of the port (no torch.optim):
ports of `repro/optim/{adafactor,adamw,schedules}.py`."""
