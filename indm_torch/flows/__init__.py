"""Residual flow and wolf prior flow (PyTorch)."""
