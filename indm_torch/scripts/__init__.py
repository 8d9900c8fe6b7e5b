"""Benchmarks of the port, run as modules:
`python -m indm_torch.scripts.<name>`."""
