"""Device ms a step of cuDNN's and cuBLAS's kernels: the deep scales'
convolutions, their gradients and the LRN's band product."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 1e3 * ctx.trace.families_s.get("cuDNN / GEMM", 0.0) / ctx.units
