"""The sLSTM scan (K8): ref / kernel / ops."""
