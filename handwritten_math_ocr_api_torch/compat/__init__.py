"""Converters from the reference implementation's PyTorch checkpoints."""
