"""setup_s: process start to the first timed request (host clock): imports,
the kernels' load (their build on a checkout's first run), the seeded
weights on the card through the program's converter, a short warm-up
request at the cell's shapes."""


def read(run):
    return run.setup_s
