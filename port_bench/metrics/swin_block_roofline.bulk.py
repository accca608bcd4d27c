"""B4 (csrc/swin_block.cu): the bound time of its launches' work over their
device time, in the traced window. Each traced decode encodes its bucket
once, the blocks of stages 1-3 each one launch; the counters must agree
with that and with the trace, or nothing is read."""

from harness import roofline
from harness.readers import complete_trace, traced_decodes

KERNELS = ("swin_block_kernel", "swin_block_mma_kernel")


def read(run):
    t = complete_trace(run)
    ds = traced_decodes(run)
    if t is None or not ds or run.model["encoder"] != "swin_t":
        return None
    nbytes, flops, n = roofline.encode_work(run.model,
                                            [d.bucket for d in ds])
    launched = t.launches.get(("fused_swin_block", "launches"))
    if n != launched or t.kernel_count(*KERNELS) != launched:
        return None
    seconds = t.kernel_seconds(*KERNELS)
    return roofline.bound_ms(nbytes, flops) * 1e-3 / seconds * 100.0
