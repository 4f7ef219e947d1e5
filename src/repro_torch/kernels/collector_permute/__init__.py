"""Collector row gathers: the shuffle (K1) and the route plan's bucket gathers (K4a, K4b): ref / kernel / ops."""
