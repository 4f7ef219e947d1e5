"""Fused quantize / dequantize collector gathers (K5a, K5b): ref / kernel / ops."""
