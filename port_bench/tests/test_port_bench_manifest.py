"""BENCHMARK.json against the contract the benchmark is checked by, and
the benchmark's files against BENCHMARK.json: every cell's configuration,
traffic and limits exist; names, units and lines keep to their alphabets
and lengths; every per-layer metric has a reader and its cells report the
end-to-end metric it moves; the run length fits a full check of 24 cells;
nothing under port_bench/ imports JAX or the JAX package (top-level names
compared whole)."""

import ast
import json
import re
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in bench["paths"])
    assert all((ROOT / p).is_dir() for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) and not w.startswith("/") and ".." not in w
                                               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_run_length_fits_a_full_check_of_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["source"] == c["source"] and sorted(body["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        widths = re.compile(r"(hidden|intermediate|latent|state|projection|head).*size|_dim$|_rank$|expansion|per_tok")
        assert not any(widths.search(k) for k in c["reduced"])
        # each cut is set in one place: the configuration's own key, or the key of every traffic file run with it
        for key in c["reduced"]:
            traffics = {w["traffic"] for w in bench["workloads"] if w["config"] == c["name"]}
            in_traffic = all(key in json.loads((PB / "traffic" / f"{t}.json").read_text()) for t in traffics)
            assert (key in body) != in_traffic, (c["name"], key)
            assert key not in body.get("flags", {}), (c["name"], key)


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "limits" / f"{w['name']}.json").is_file()


def _reports(bench, metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics(bench):
    e2e, per_layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per_layer]
    assert len(set(names)) == len(names) and 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    assert any(m["name"] == "setup_s" for m in e2e)
    cells = [w["name"] for w in bench["workloads"]]
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0 < m["bound"] <= 0.25
    for m in e2e + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= set(cells)
    for m in per_layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and (PB / "metrics" / f"{m['name']}.py").is_file()
        moved = next(e for e in e2e if e["name"] == m["moves"])
        assert all(_reports(bench, moved, c) for c in m.get("workloads", cells))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:  # setup_s, one more end-to-end metric and one per-layer metric in every cell
        assert sum(_reports(bench, m, c) for m in e2e) >= 2
        assert any(_reports(bench, m, c) for m in per_layer)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_nothing_under_port_bench_imports_jax():
    banned = {"jax", "jaxlib", "flax", "wav2vec2forbrain_tpu"}
    for path in PB.rglob("*.py"):
        assert not {m.split(".")[0] for m in _imports(path)} & banned, path


def test_file_names_keep_to_the_name_alphabet():
    for path in PB.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", str(path.relative_to(ROOT))), path
