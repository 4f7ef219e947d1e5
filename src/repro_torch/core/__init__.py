"""SFPL core: collector, route plans and wire format, BN policies, round
engines (one device and a process group), evaluation, fault plans and
retries, and SFPL for the LM loss."""
from repro_torch.core import (bn_policy, collector, collector_dist, engine,
                              engine_dist, evaluate, faults, retry, round,
                              split_lm, wire)
