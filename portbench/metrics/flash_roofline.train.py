"""The flash kernels' share of their roofline in the profiled train steps:
each layer's causal attention forward and backward FLOPs at the cell's
batch and sequence (``harness/arith.py``) at the bf16 peak, over the
device time of the kernels named here, in percent."""
from portbench.harness import arith

#: the kernels that do this work (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(run):
    profile = run.profile
    if profile is None or not profile.units:
        return None
    spent = profile.device_seconds(KERNELS)
    if spent <= 0:
        return None
    shape = arith.Shape.of(run.config)
    traffic = run.cell["traffic"]
    shapes = (traffic["batch"], traffic["seq_len"], shape.heads,
              shape.head_dim)
    flops = profile.units * shape.layers * (
        arith.flash_fwd_flops(*shapes) + arith.flash_bwd_flops(*shapes))
    return 100.0 * flops / arith.PEAK_BF16_FLOPS / spent
