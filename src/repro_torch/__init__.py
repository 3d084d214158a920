"""PyTorch/CUDA port of the SMLT reproduction (``repro``), module for
module. Imports torch and numpy only; the hand-written CUDA kernels build
at first use (``repro_torch.kernels._build``)."""
