"""Synthetic data (numpy): the CIFAR-like images with the paper's non-IID
partition, and the LM token streams."""
