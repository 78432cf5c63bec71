"""vae_decode_ms_per_image: device time of the operations launched inside
the benchmark's span around each VAE decoder forward, over the images
decoded."""


def read(run):
    t = run.trace
    if t is None or not t.rows.get("vae_decode") or not t.span_device_s.get("vae_decode"):
        return None
    return 1e3 * t.span_device_s["vae_decode"] / t.rows["vae_decode"]
