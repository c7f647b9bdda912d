"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re

import pytest

from rtbench import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [c["name"] for c in MAN["workloads"]]
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in MAN["per_layer"]:
        assert line(m["layer"])


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_files_and_metrics(cell):
    w = manifest.cell(MAN, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").exists()
    limits = manifest.limits(cell)
    assert limits and all(v >= 0 for v in limits.values())
    e2e, layer = manifest.cell_metrics(MAN, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e:
        assert manifest.reader("e2e", m["name"])
    for m in layer:
        assert manifest.reader("metrics", m["name"])


def test_configuration_and_traffic_pairs_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert manifest.reports(E2E[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_layer_name_is_one_layer():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
