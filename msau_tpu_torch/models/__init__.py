"""The MSAU model in PyTorch (NCHW inside, NHWC at the public forward)."""
