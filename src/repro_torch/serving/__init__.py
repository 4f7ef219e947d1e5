"""Serving of the port: the continuous-batching scheduler."""
from repro_torch.serving.scheduler import ContinuousBatcher, Request
