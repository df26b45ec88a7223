"""Optimizers, learning-rate schedules and gradient compression of the
port (no torch.optim): ports of
`repro/optim/{adafactor,adamw,schedules,compression}.py`."""
