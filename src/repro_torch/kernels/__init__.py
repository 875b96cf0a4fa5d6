"""Hand-written Hopper kernels of the port, one package per TPU kernel of
``repro.kernels``; each keeps its plain PyTorch version beside it."""
