"""Models (ResNet-20)."""
