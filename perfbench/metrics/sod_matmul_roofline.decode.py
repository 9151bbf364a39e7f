"""sod_matmul_roofline.decode: the yardstick's least time of the `sod_matmul`
calls of the traced decode phases over their device time, in %."""
from perfbench.harness import devtrace


def read(rec):
    return devtrace.roofline(rec, "sod_matmul_kernel", "decode")
