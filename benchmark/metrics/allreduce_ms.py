"""Device ms a call of the NCCL all-reduce kernels (a name holding
``nccl`` and ``AllReduce``, either case), summed over the cards, in the
profiled calls.  A kernel's time includes its wait for the slower card
of its dp row."""

from . import per_frame


def read(ctx):
    us = sum(us for n, us in ctx["profile"].get("kernels", {}).items()
             if "nccl" in n.lower() and "allreduce" in n.lower())
    return per_frame(ctx, us)
