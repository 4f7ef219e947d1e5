"""Fused collector row gather (K1): ref / kernel / ops."""
