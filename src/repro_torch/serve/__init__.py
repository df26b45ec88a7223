"""Continuous-batching serving of the PyTorch port: sampler, scheduler
and engine."""
