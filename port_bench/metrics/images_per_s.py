"""images_per_s: all images completed in the window over the window's
seconds, from the start of its first request to the end of its last (host
clock; each request ends when its uint8 images are on the host)."""


def read(run):
    if run.window_s <= 0 or run.images == 0:
        return None
    return run.images / run.window_s
