"""k5_roofline_pct: the calls of ``sdt_torch::scaled_silu_conv3x3`` in the traced
window: the sum of each call's roofline bound (operations at the bf16 peak
or bytes at the HBM rate, whichever is larger, from its recorded shapes)
over the sum of the device time of the kernels it launched, in percent."""

from port_bench import flops


def read(run):
    if run.trace is None:
        return None
    return flops.roofline_pct(run.trace.op_calls, "sdt_torch::scaled_silu_conv3x3")
