"""Models of the port: the split CIFAR ResNet."""
