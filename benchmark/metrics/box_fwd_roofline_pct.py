"""The box convolution forward's share of its roofline: the step's calls'
bounds (``box_counts``, bytes-bound) over ``msau::box::filter_fwd``'s
device time a step, in %; None where the launch counter is not one a call
(``box_roofline.share``)."""

from benchmark.box_roofline import share


def read(ctx):
    return share(ctx, "fwd")
