"""Kernel E's share of its roofline, % (``roofline.kernel_share``)."""
from portbench.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "E_mask")
