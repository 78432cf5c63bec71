"""unet_ms_per_eval: device time of the operations launched inside the
benchmark's span around each UNet forward, over the UNet evaluations."""


def read(run):
    t = run.trace
    if t is None or not t.calls.get("unet") or not t.span_device_s.get("unet"):
        return None
    return 1e3 * t.span_device_s["unet"] / t.calls["unet"]
