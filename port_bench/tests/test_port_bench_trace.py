"""The reduction of a trace to what the per-layer metrics read, on
synthetic profiler events: the union of device intervals, the launch
moment of each operation, spans and op calls that own it, the idle gaps
by span, and the readers' arithmetic."""

from types import SimpleNamespace

import pytest

from port_bench import flops, harness, trace


class Ev:
    """The part of a ``torch.profiler`` KinetoEvent the reduction reads."""

    def __init__(self, name, start, dur, *, cuda=False, corr=0, linked=0, shapes=(),
                 dtypes=()):
        self._n, self._s, self._d, self._cuda = name, start, dur, cuda
        self._c, self._l, self._shapes, self._dtypes = corr, linked, list(shapes), list(dtypes)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return SimpleNamespace(name="CUDA" if self._cuda else "CPU")

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def shapes(self):
        return self._shapes

    def dtypes(self):
        return self._dtypes


def _spans(**intervals):
    s = trace.Spans({}, ranges=False)
    for k, ivs in intervals.items():
        s.intervals[k] = list(ivs)
    s.calls["unet"] = len(intervals.get("unet", ()))
    return s


def test_timeline_union_window_and_gaps():
    # two requests [0, 100] and [120, 200]; UNet forwards [10, 60], [130, 180]
    spans = _spans(request=[(0, 100), (120, 200)], unet=[(10, 60), (130, 180)])
    events = [Ev("cudaLaunchKernel", 12, 1, corr=1), Ev("gemm", 20, 30, cuda=True, corr=1),
              Ev("cudaLaunchKernel", 13, 1, corr=2), Ev("gemm", 40, 20, cuda=True, corr=2),
              Ev("cudaLaunchKernel", 14, 1, corr=3), Ev("Memcpy HtoD", 70, 10, cuda=True,
                                                         corr=3),
              Ev("cudaLaunchKernel", 131, 1, corr=4), Ev("gemm", 150, 60, cuda=True, corr=4)]
    t = trace.Trace()
    trace.timeline(t, events, spans)
    assert t.window_s == pytest.approx(200e-9)
    # [20, 60] and [70, 80] and [150, 200] (clipped at the window's end)
    assert t.busy_s == pytest.approx(100e-9)
    assert t.n_kernels == 3 and t.unet_evals == 2
    gaps = dict(t.idle_gaps)
    # gap [0, 20] is before the first op: not a gap between operations;
    # [60, 70] mid 65 in the request outside the UNet; [80, 150] mid 115
    # between requests
    assert gaps["host in request, outside the UNet and VAE"] == pytest.approx(10e-9)
    assert gaps["host between requests"] == pytest.approx(70e-9)
    assert t.device_ops[0] == ["gemm", pytest.approx(100e-9)]


def test_attribution_by_launch_moment():
    spans = trace.Spans({}, ranges=True)
    spans.intervals["unet"] = [(0, 50)]
    q = [2, 4096, 320]
    events = [Ev("port_bench.unet", 0, 50, corr=100),
              Ev("port_bench.unet", 5, 500, cuda=True, corr=0),  # the annotation's device side
              Ev("sdt_torch::flash_attention_bsc", 10, 10, corr=101, shapes=[q, q, q, []],
                 dtypes=["c10::BFloat16"] * 3),
              Ev("cuLaunchKernelEx", 12, 2, corr=7),
              Ev("attention_tc_kernel<40, 3>", 100, 86_800, cuda=True, corr=7, linked=101),
              Ev("aten::add", 30, 5, corr=102),
              Ev("add_kernel", 300, 1000, cuda=True, corr=8, linked=102),  # no runtime event
              Ev("aten::copy_", 60, 5, corr=103),
              Ev("copy_kernel", 90_000, 400, cuda=True, corr=9, linked=103)]  # after the span
    t = trace.Trace()
    trace.attribution(t, events, spans)
    assert t.span_device_s["unet"] == pytest.approx((86_800 + 1000) / 1e9)
    (call,) = t.op_calls
    assert call.device_s == pytest.approx(86_800e-9) and call.shapes[0] == q
    # 0.0434 ms bound over 0.0868 ms: half the roofline
    assert flops.roofline_pct(t.op_calls, "sdt_torch::flash_attention_bsc") == \
        pytest.approx(50.0, rel=2e-3)


def test_readers_of_a_trace():
    t = trace.Trace(window_s=10.0, busy_s=9.0, n_kernels=3000, unet_evals=2,
                    flops=989e12, span_device_s={"unet": 0.5, "vae_decode": 0.2},
                    calls={"unet": 5}, rows={"vae_decode": 4})
    run = SimpleNamespace(trace=t)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(10.0)
    assert harness.reader("mfu")(run) == pytest.approx(10.0)
    assert harness.reader("launches_per_eval")(run) == 1500
    assert harness.reader("unet_ms_per_eval")(run) == pytest.approx(100.0)
    assert harness.reader("vae_decode_ms_per_image")(run) == pytest.approx(50.0)
    # nothing to read: no value, never a 0
    for name in ("k1_roofline_pct", "k3_roofline_pct", "k4_roofline_pct", "k5_roofline_pct"):
        assert harness.reader(name)(run) is None
    assert harness.reader("mfu")(SimpleNamespace(trace=None)) is None
