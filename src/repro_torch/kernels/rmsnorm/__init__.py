"""Fused RMSNorm (K6): ref / kernel / ops."""
