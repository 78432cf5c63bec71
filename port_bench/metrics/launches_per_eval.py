"""launches_per_eval: the kernels the profiler recorded in the traced
timeline over the UNet evaluations in it (forwards of the UNet, counted by
the benchmark's hooks)."""


def read(run):
    t = run.trace
    if t is None or not t.unet_evals or t.n_kernels == 0:
        return None
    return t.n_kernels / t.unet_evals
