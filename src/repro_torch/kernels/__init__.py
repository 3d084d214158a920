"""Hand-written CUDA kernels for the compute hot spots, each beside its plain
PyTorch version:

 - hier_agg:        shard mean-aggregation (the paper's shard aggregator)
                    and the fused aggregate-and-apply
 - flash_attention: online-softmax causal / sliding-window attention
 - ssd_scan:        the Mamba2 SSD chunked scan (forward)

``ops`` holds the padded public entry points, ``ref`` the plain oracles,
``_build`` the nvcc build and the ctypes binding (run at first use).
"""
