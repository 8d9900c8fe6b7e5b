"""NCSN++ score network (PyTorch)."""
