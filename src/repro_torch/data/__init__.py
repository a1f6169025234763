"""Synthetic CIFAR-like data and the paper's non-IID partition (numpy)."""
