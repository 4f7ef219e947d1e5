"""Models of the port: the split CIFAR ResNet, the decoder transformer and
the xLSTM."""
