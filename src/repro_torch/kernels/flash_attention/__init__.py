"""Flash attention (K7): ref / kernel / ops."""
