"""Fused softmax cross-entropy (K3): ref / kernel / ops."""
