"""Kernel D's share of its roofline, % (``roofline.kernel_share``)."""
from portbench.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "D_istft")
