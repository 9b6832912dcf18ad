"""The flash attention's share of its roofline over the traced steps, in %:
the bound of every forward and backward call (``counts``: the cell's causal
attention shapes, whatever implements them) over the device time of the
kernels launched inside the port's ``_FlashAttention`` op and its backward."""

from gpubench import counts

OPS = ("_FlashAttention", "_FlashAttentionBackward")


def read(run):
    if run.trace is None:
        return None
    seconds = sum(run.trace.op_kernel_s.get(op, 0.0) for op in OPS)
    if seconds <= 0:
        return None
    b, s = run.traffic["batch"] // run.traffic["microbatches"], run.traffic["seq"]
    bound = (run.trace.op_calls.get(OPS[0], 0) * counts.flash_fwd_bound_s(run.arch, b, s)
             + run.trace.op_calls.get(OPS[1], 0) * counts.flash_bwd_bound_s(run.arch, b, s))
    return 100.0 * bound / seconds
