"""Device milliseconds a step in GEMM kernels (cuBLAS and CUTLASS kernels by
name: ``gemm``, ``nvjet``, ``cutlass``, ``xmma``), over the traced window."""

import re

GEMM = re.compile(r"gemm|nvjet|cutlass|xmma", re.IGNORECASE)


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace.kernel_s.items() if GEMM.search(name))
    return 1e3 * seconds / run.window.steps if seconds > 0 else None
