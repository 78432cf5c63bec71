"""mfu: the operations the model needs for the requests completed in the
traced window (text towers, every UNet evaluation at its CFG batch, the VAE
decode; the entry's ``request_flops`` from the configuration's shapes), over the
window's seconds, as a share of the H100's dense bf16 peak."""

from port_bench import flops


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.flops <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * t.flops / t.window_s / flops.PEAK_FLOPS_BF16
