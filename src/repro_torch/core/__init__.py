"""SFPL core on one device: collector, BN policies, round engine, evaluation."""
from repro_torch.core import (bn_policy, collector, engine, evaluate,
                              round)
