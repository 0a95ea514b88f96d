"""BENCHMARK.json keeps to its format (keys, names, units, bounds), and
every name in it leads to its files."""

import json
import re
import shutil

import pytest

from benchmark.core import isolation, spec
from benchmark.tests.tiny import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SPEC = spec.load(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_format_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = spec.cell(ROOT, cell)
    assert spec.kind(c["config"]).setup
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(spec.reader(ROOT, m["name"]))
    for m in c["per_layer"]:
        # the end-to-end metric a per-layer metric moves is reported too
        assert m["moves"] in e2e
    assert set(c["checks"]["limits"])


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic mix, metric and cell: files and
    entries only, no file of the harness edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / s["configs"][0]["file"]).read_text())
    cfg["options"]["beam_width"] = 8
    (tmp_path / "benchmark/configs/dummy-cfg.json").write_text(
        json.dumps(cfg))
    t = json.loads((ROOT / "benchmark/traffic/bulk.json").read_text())
    t["reads_per_call"] = 512
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(t))
    (tmp_path / "benchmark/checks/dummy.cell.json").write_text(
        json.dumps({"limits": {"prob_gap": 1.0}}))
    (tmp_path / "benchmark/metrics/dummy_ms.py").write_text(
        "def read(run):\n    return 1.5\n")
    s["configs"].append({"name": "dummy-cfg", "source": "https://x.org",
                         "file": "benchmark/configs/dummy-cfg.json",
                         "reduced": [], "why": "w"})
    s["workloads"].append({"name": "dummy.cell", "config": "dummy-cfg",
                           "traffic": "dummy_mix", "chips": 1, "why": "w"})
    s["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "x", "moves": "Msamples_per_s",
                           "workloads": ["dummy.cell"]})
    s["end_to_end"][0]["workloads"].append("dummy.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    c = spec.cell(tmp_path, "dummy.cell")
    assert c["config"]["options"]["beam_width"] == 8
    assert c["traffic"]["reads_per_call"] == 512
    assert [m["name"] for m in c["per_layer"]] == ["dummy_ms"]
    assert spec.reader(tmp_path, "dummy_ms")(None) == 1.5
    assert "Msamples_per_s" in [m["name"] for m in c["end_to_end"]]


def test_sources_import_no_jax_nor_the_jax_package():
    assert isolation.source_faults(ROOT / "benchmark") == []


def test_forbidden_names_are_whole_top_level_names():
    mods = {"radian_tpu_torch.pipeline": 1, "jaxtyping": 1, "numpy": 1}
    assert isolation.loaded_forbidden(mods) == []
    mods.update({"radian_tpu.ops": 1, "jax.numpy": 1, "flax": 1})
    assert isolation.loaded_forbidden(mods) == ["flax", "jax.numpy",
                                                "radian_tpu.ops"]
