"""block_matmul_roofline.decode: the yardstick's least time of the
`block_matmul` calls of the traced decode phases over their device time, in %."""
from perfbench.harness import devtrace


def read(rec):
    return devtrace.roofline(rec, "block_matmul_kernel", "decode")
