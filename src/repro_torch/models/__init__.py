"""Models of the port: the split CIFAR ResNet and the decoder
transformer."""
