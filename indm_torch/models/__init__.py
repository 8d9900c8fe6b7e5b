"""The score networks (PyTorch): NCSN++, DDPM, the NCSNv2 RefineNets and
VDM, and their layers and normalizations."""
