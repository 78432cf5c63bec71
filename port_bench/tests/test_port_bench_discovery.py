"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix, entry, loop and check limits by name, every
metric its reader, and the file keeps to the contract's shape."""

import json
import re
from pathlib import Path

import pytest

from port_bench import harness, traffic
from port_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_load_by_name(cell):
    c = harness.load_cell(ROOT, cell["name"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and len(cell["why"]) <= 200
    assert c.chips == 1
    assert set(c.checks["limits"]) and c.checks["images"] >= 1
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configurations(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("port_bench/configs/") and conf["reduced"] == []
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["serving"]["policy"] == "bf16"


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_have_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert len({m["layer"] for m in BENCH["per_layer"] if m["layer"] == metric["layer"]})
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


MIXES = sorted(p.stem for p in (ROOT / "port_bench/traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_mixes_find_their_entry_and_loop(name):
    mix = json.loads((ROOT / "port_bench/traffic" / f"{name}.json").read_text())
    assert len(mix["source"]) <= 200 and "\n" not in mix["source"]
    ent = harness.entry(mix["entry"])
    assert callable(ent.serve) and callable(ent.reference)
    assert ent.request_flops(tiny.sd()["model"] if mix["entry"] == "hires_fix"
                             else tiny.sdxl()["model"], {**mix, "height": 64, "width": 64,
                                                         "base_height": 32,
                                                         "base_width": 32}) > 0
    assert callable(harness.part("loops", mix["loop"]).drive)
    req = traffic.request(mix, 5, 0, traffic.words())
    assert not set(req) & set(traffic.RUN_KEYS)


def test_a_missing_part_is_named():
    with pytest.raises(SystemExit, match="entries/no_such_entry.py"):
        harness.entry("no_such_entry")


def test_closed_loop_serves_whole_requests_until_the_window_closes():
    loop = harness.part("loops", "closed")
    served = []

    def one():
        served.append(len(served))
        return len(served) < 5

    loop.drive({"clients": 1}, one, 60.0)
    assert served == [0, 1, 2, 3, 4]  # stops at the first failure
    served.clear()
    loop.drive({"clients": 1}, lambda: served.append(0) or True, 0.0)
    assert served == [0]  # a closed window still serves one whole request
    with pytest.raises(ValueError):
        loop.drive({"clients": 2}, one, 1.0)


def test_traffic_vocabulary_is_one_token_a_word():
    vocab, merges = traffic.vocabulary()
    words = traffic.words()
    assert len(words) == 25 ** 3 and max(vocab.values()) < 49408
    from pytorch_stable_diffusion_tpu_torch.weights.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer(vocab, merges, 77)
    sample = words[::997]
    ids = tok.encode(" ".join(sample))
    assert ids[1:1 + len(sample)] == [vocab[w + "</w>"] for w in sample]


def test_requests_follow_the_seed():
    mix = json.loads((ROOT / "port_bench/traffic/t2i512.b8.json").read_text())
    a = traffic.request(mix, 2**31 + 3, 4, traffic.words())
    b = traffic.request(mix, 2**31 + 3, 4, traffic.words())
    c = traffic.request(mix, 2**31 + 4, 4, traffic.words())
    assert a == b and a["prompts"] != c["prompts"]
    assert len(a["prompts"]) == 8 and all(len(p.split()) == 75 for p in a["prompts"])
