"""Models: K-FAC-aware layers, the CIFAR and ImageNet ResNet zoos, the
transformer LM and the word-level RNN LM."""
