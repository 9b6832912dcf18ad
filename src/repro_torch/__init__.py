"""PyTorch/CUDA port of the ``repro`` package, grown slice by slice beside it.

So far: the serving path of the dense decoder family (configs, hand-written
RMSNorm and flash-attention kernels for Hopper, the transformer's paged
prefill/decode, and the continuous-batching engine with its load generator).
Imports ``torch`` and numpy only.
"""
