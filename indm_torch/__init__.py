"""INDM in PyTorch for NVIDIA Hopper: the port of `indm_tpu`.

NCHW modules, explicit devices and `torch.Generator`s; every kernel that the
JAX package wrote in Pallas becomes a hand-written CUDA kernel under
`indm_torch/csrc/`, built at first use. Entry points run on `cuda` unless
the caller passes `device="cpu"`.
"""
