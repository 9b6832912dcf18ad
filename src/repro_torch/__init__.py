"""PyTorch/CUDA port of the ``repro`` package, grown slice by slice beside it.

So far: the serving path of the dense decoder family (configs, hand-written
RMSNorm and flash-attention kernels for Hopper, the transformer's paged
prefill/decode, and the continuous-batching engine with its load generator);
zamba2's prefill and decode on the Mamba2 SSD chunk-scan kernel; and the dense
family's training path (the kernels' backwards, ``forward``/``loss``, AdamW,
schedules, the synthetic data pipeline, checkpointing, the fault-tolerant
trainer and its launcher, one device).  Imports ``torch`` and numpy only.
"""
