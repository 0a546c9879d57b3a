"""The harness: BENCHMARK.json holds to the benchmark's contract, every name
in it loads, a run's last line has the contract's keys, and nothing of JAX
or the JAX package is loaded by a run."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from tinylfu_bench import harness
from tinylfu_bench.tests.bench_cases import CASES, bench_all, run_small

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
# with the cells under pending/, which BENCHMARK.json leaves out
BENCH_ALL = bench_all()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def one_line(text: str, limit: int = 200) -> bool:
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "tinylfu_bench/run.py"]
    assert BENCH["paths"] == ["tinylfu_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    _entries_hold(BENCH)


def _entries_hold(bench: dict) -> None:
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        names = [e["name"] for e in bench[part]]
        assert len(names) == len(set(names)), part
        for e in bench[part]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert one_line(e[k]), (e["name"], k)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_bounds_and_sources():
    _bounds_hold(BENCH)


def _bounds_hold(bench: dict) -> None:
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline_pct")


def test_cells_configs_and_metrics_fit_together():
    _cells_fit(BENCH)


def test_pending_cells_fit_the_contract_beside_the_benchmark():
    assert len(BENCH_ALL["workloads"]) > len(BENCH["workloads"])
    _entries_hold(BENCH_ALL)
    _bounds_hold(BENCH_ALL)
    _cells_fit(BENCH_ALL)


def _cells_fit(bench: dict) -> None:
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for name, cell in cells.items():
        reported = [m["name"] for m in harness.cell_metrics(bench, cell,
                                                            False)]
        assert "setup_s" in reported and len(reported) >= 2, name
        assert harness.cell_metrics(bench, cell, True), name
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"]
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (
                m["name"], w)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_ALL["workloads"]])
def test_every_name_loads(cell):
    c, config, traffic = harness.load_cell(BENCH_ALL, cell)
    entry = {e["name"]: e for e in BENCH_ALL["configs"]}[c["config"]]
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith("tinylfu_bench/configs/")
    assert config["name"] == c["config"] and config["reduced"] == []
    assert traffic["name"] == c["traffic"]
    drv = harness.driver(config["system"])
    assert hasattr(drv, "Session") and drv.SPANS
    for m in (harness.cell_metrics(BENCH_ALL, c, False)
              + harness.cell_metrics(BENCH_ALL, c, True)):
        assert callable(harness.reader(m["name"]).read)


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "tinylfu_bench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", sorted(CASES))
def test_small_runs_are_correct_with_the_contract_keys(cell, traced):
    r = run_small(cell, traced=traced)
    keys = RESULT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert all(c["limit"] == 0 and c["value"] == 0
               for c in r["checks"].values())
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        bench_cell = {w["name"]: w for w in BENCH_ALL["workloads"]}[cell]
        want = {m["name"] for m in harness.cell_metrics(BENCH_ALL, bench_cell,
                                                        False)}
        # a CPU run has no device memory to read
        assert set(r["metrics"]) == want - {"device_mem_gib"}
    json.dumps(r)


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.core", "jaxtyping", "numpy", "flaxen"]
    assert harness.forbidden_loaded(ok) == []
    assert harness.forbidden_loaded(ok + ["repro.core.sketch", "jax.numpy",
                                          "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "from tinylfu_bench.tests.bench_cases import run_small;"
            "from tinylfu_bench import harness;"
            "r = run_small('admit-zipf09-b16384');"
            "print(r['correct'], harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["True", "[]"]


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "tinylfu_bench/run.py", "--workload",
         "zipf09-single", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_without_the_program_the_run_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tinylfu_bench", tmp_path / "tinylfu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "tinylfu_bench/run.py", "--workload",
         "zipf09-single", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "tinylfu_bench/run.py", "--workload", cell,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
