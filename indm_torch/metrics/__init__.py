"""FID, KID and Inception Score (PyTorch), and the InceptionV3 feature
network they read."""
