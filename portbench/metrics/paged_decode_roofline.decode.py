"""The paged-decode kernel's share of its roofline: the bytes the
profiled ticks' contexts need (int8 K/V rows with their scales, the
page-table entries, q and the output, each once; ``harness/arith.py``) at
HBM bandwidth, over the device time of the kernels named here, in
percent."""
from portbench.harness import arith

#: the kernels that do this work (csrc/paged_decode.cu)
KERNELS = ("paged_decode",)


def read(run):
    profile = run.profile
    if profile is None:
        return None
    spent = profile.device_seconds(KERNELS)
    if spent <= 0:
        return None
    shape = arith.Shape.of(run.config)
    page = run.config["serving"]["page_size"]
    need = sum(arith.paged_decode_bytes(context, shape, page)
               for tick in run.ticks if tick["traced"] == profile.session
               for context in tick["contexts"])
    return 100.0 * need / arith.PEAK_HBM_BYTES_PER_S / spent
