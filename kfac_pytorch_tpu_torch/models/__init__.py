"""Models: K-FAC-aware layers and the CIFAR ResNet zoo."""
