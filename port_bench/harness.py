"""One run of one cell: set-up, the measured (or traced) window, the
correctness check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), the
entry and the loop that the mix names (``entries/<entry>.py``: the
program's call, the reference's and the operations of a request;
``loops/<loop>.py``), its check limits (``checks/<cell>.json``) and one
reader a metric (``metrics/<name>.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_stable_diffusion_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What a run measured; the metric readers take it."""

    cell: Cell
    setup_s: float
    requests: List[dict] = field(default_factory=list)
    window_s: float = 0.0
    images: int = 0
    trace: Optional[object] = None
    request_flops: float = 0.0
    failed: int = 0


def _listed_for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    with open(BENCH_DIR / "checks" / f"{name}.json") as f:
        checks = json.load(f)
    return Cell(name=name, chips=cell["chips"], config=config, mix=mix, checks=checks,
                end_to_end=[m for m in bench["end_to_end"] if _listed_for(m, name)],
                per_layer=[m for m in bench["per_layer"] if _listed_for(m, name)])


def part(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} {name!r}: {path.relative_to(BENCH_DIR.parent)} is missing")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    return part("metrics", name).read


def entry(name: str):
    """``entries/<name>.py``: ``serve(server)``, ``reference(ref, request, j)``
    and ``request_flops(model, mix)``."""
    return part("entries", name)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ set-up
def setup(cell: Cell, seed: int, device, t_start: float, *, quant: str = "none"):
    """The program loaded and warmed at the cell's shapes: -> (server, run)."""
    import torch

    from . import system, traffic, weights

    system.import_program()
    parts = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        system.load_kernels()
    parts["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    config = system.port_config(cell.config, quant=quant)
    tensors = weights.draw_checkpoint(cell.config["model"], seed, device,
                                      weights.served_dtype(cell.config))
    models = system.load_models(config, tensors)
    del tensors
    _sync(device)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    vocab, merges = traffic.vocabulary()
    tok = system.tokenizer(vocab, merges, cell.config["model"]["text_encoders"][0]
                           ["context_length"])
    server = system.Server(entry(cell.mix["entry"]), models, tok, config, device)
    server(traffic.warmup(cell.mix, seed))
    _sync(device)
    parts["warmup_s"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell=cell, setup_s=time.perf_counter() - t_start,
              request_flops=entry(cell.mix["entry"]).request_flops(cell.config["model"],
                                                                   cell.mix))
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; setup_s {run.setup_s:.3f}")
    return server, run


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ window
def window(server, run: Run, seed: int, seconds: float, device, *, traced: bool) -> Dict:
    """The mix's loop (``loops/<loop>.py``) over whole requests until
    ``seconds`` have passed; or, traced, the two passes of ``trace.py`` (the
    mix's ``trace_requests`` requests one after another, then one more).
    -> {request index: (request, images)}."""
    from . import traffic

    outputs: Dict = {}
    gen = traffic.requests(run.cell.mix, seed)

    def one(spans=None) -> bool:
        req = next(gen)
        r0 = time.perf_counter()
        try:
            if spans is None:
                images = server(req)
            else:
                with spans.request():
                    images = server(req)
                    _sync(device)
        except Exception as exc:  # a request the program fails counts as failed
            log(f"request {req['index']} failed: {type(exc).__name__}: {exc}")
            run.failed += 1
            images = None
        r1 = time.perf_counter()
        run.requests.append({"index": req["index"], "t0": r0, "t1": r1,
                             "images": 0 if images is None else len(images)})
        if images is None:
            return False
        outputs[req["index"]] = (req, images)
        run.images += len(images)
        return True

    if not traced:
        part("loops", run.cell.mix["loop"]).drive(run.cell.mix, one, seconds)
        run.window_s = run.requests[-1]["t1"] - run.requests[0]["t0"]
        return outputs
    run.trace = _traced(server, run, device, one)
    return outputs


def _traced(server, run: Run, device, one):
    """The timeline pass, then the attribution pass (``trace.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import system
    from . import trace as trace_mod

    cuda = torch.device(device).type == "cuda"
    modules = system.models_of(server.models)
    trace = trace_mod.Trace()
    spans = trace_mod.Spans(modules, ranges=False)
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        done = sum(one(spans) for _ in range(run.cell.mix["trace_requests"]))
    spans.close()
    run.window_s = run.requests[-1]["t1"] - run.requests[0]["t0"]
    trace_mod.timeline(trace, prof.profiler.kineto_results.events(), spans)
    trace.flops = run.request_flops * done
    log(f"trace: timeline of {done} requests, {trace.n_kernels} kernels, "
        f"{time.perf_counter() - t:.1f} s")
    if run.failed:
        return trace
    t = time.perf_counter()
    spans = trace_mod.Spans(modules, ranges=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=True) as prof:
        one(spans)
    spans.close()
    trace_mod.attribution(trace, prof.profiler.kineto_results.events(), spans)
    log(f"trace: attribution of one request, {len(trace.op_calls)} op calls, "
        f"{time.perf_counter() - t:.1f} s")
    return trace


# ------------------------------------------------------------- correctness
def sample(run: Run, outputs: Dict, seed: int) -> List[tuple]:
    """(request index, image index) pairs to check, ``checks["images"]`` in
    all: the last request's first image, then one image of each other slot
    of the batch, the slots in an order drawn from the seed and each from a
    request drawn from the seed; every slot once before any twice."""
    rng = random.Random(f"{seed}/check")
    reqs = sorted(outputs)
    batch = len(outputs[reqs[-1]][1])
    want = min(run.cell.checks["images"], len(reqs) * batch)
    picks = [(reqs[-1], 0)]
    slots = list(range(1, batch))
    while len(picks) < want:
        if not slots:
            slots = list(range(batch))
        slot = slots.pop(rng.randrange(len(slots)))
        free = [i for i in reqs if (i, slot) not in picks]
        if free:
            picks.append((rng.choice(free), slot))
    return picks


def compare(program, reference) -> Dict[str, float]:
    """The numbers a checked image is judged by: ``pct_off3``, the share of
    its uint8 values 3 or more levels from the reference's, in percent (the
    bf16 program's rounding leaves nearly all within 2; the int8 control
    pushes some percent past them), and ``image_rms`` in levels, printed
    for the record and not judged."""
    import numpy as np

    d = np.abs(np.asarray(program, np.int16) - np.asarray(reference, np.int16))
    return {"pct_off3": 100.0 * float((d >= 3).mean()),
            "image_rms": float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))}


def check(cell: Cell, outputs: Dict, picks: List[tuple], seed: int, device) -> Dict:
    """The reference, in float32 with TF32 off, over the picked images:
    -> {number: worst reading}."""
    import torch

    from . import traffic, weights
    from .reference.pipeline import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tensors = weights.draw_checkpoint(cell.config["model"], seed, device,
                                      weights.served_dtype(cell.config))
    vocab, _ = traffic.vocabulary()
    ref = Reference(cell.config["model"], tensors, vocab, device)
    worst: Dict[str, float] = {}
    ent = entry(cell.mix["entry"])
    for i, j in picks:
        req, images = outputs[i]
        with torch.inference_mode():
            want = ent.reference(ref, req, j)
        got = compare(images[j], want.cpu().numpy())
        log(f"checked request {i} image {j}: " + ", ".join(f"{k} {v:.4f}"
                                                           for k, v in got.items()))
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


# -------------------------------------------------------------------- run
def device_info(device, chips: int) -> Dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def execute(cell: Cell, *, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> Dict:
    """A whole run; -> the result object (the last line of a run)."""
    server, run = setup(cell, seed, device, t_start)
    outputs = window(server, run, seed, seconds, device, traced=traced)
    dev = device_info(device, cell.chips)
    log(f"window: {len(run.requests)} requests, {run.images} images in {run.window_s:.3f} s; "
        f"peak_mem_gib {dev['memory_peak_bytes'] / 2**30:.3f}")
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    del server
    gc.collect()
    if dev["platform"] == "gpu":
        import torch

        torch.cuda.empty_cache()
    readings = {}
    if outputs:
        picks = sample(run, outputs, seed)
        readings = check(cell, outputs, picks, seed, device)
    checks = {k: {"value": readings.get(k), "limit": v["limit"]}
              for k, v in cell.checks["limits"].items()}
    correct = run.failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                      for c in checks.values())
    result = {"correct": correct, "attempted": len(run.requests), "failed": run.failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return result
