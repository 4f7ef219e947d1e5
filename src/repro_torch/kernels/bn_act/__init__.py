"""Fused BN affine + ReLU epilogue (K2): ref / kernel / ops."""
