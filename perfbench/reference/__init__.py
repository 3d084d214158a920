"""Plain PyTorch models that decide ``correct``: one file per family,
float32 with TF32 off, no kernels, no cache, no batching. They import
neither ``jax``, ``repro`` nor ``repro_torch``, and take nothing the
program made: the weights are the benchmark's (``make_weights``), in the
parameter layout the program reads."""
