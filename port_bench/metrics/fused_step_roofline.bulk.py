"""B1 (csrc/fused_step.cu): the bound time of its launches' work over their
device time, in the traced window. Each traced decode of ``bucket`` rows
and ``steps`` steps launches B1 once a step at slots 0..steps-1; the
counters must agree with that and with the trace, or nothing is read."""

from harness import roofline
from harness.readers import complete_trace, traced_decodes

KERNELS = ("fused_step_cluster_kernel",)


def read(run):
    t = complete_trace(run)
    ds = traced_decodes(run)
    if t is None or not ds:
        return None
    nbytes, flops, n = roofline.decode_work(
        run.model, [(d.bucket, d.steps) for d in ds])
    launched = t.launches.get(("fused_decoder_layers_step_v2", "launches"))
    if n != launched or t.kernel_count(*KERNELS) != launched:
        return None
    seconds = t.kernel_seconds(*KERNELS)
    return roofline.bound_ms(nbytes, flops) * 1e-3 / seconds * 100.0
