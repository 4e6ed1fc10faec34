"""Plain PyTorch references, one per configuration."""
