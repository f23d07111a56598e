"""``BENCHMARK.json`` and the files it names: the contract's shapes, names
and limits, each metric's reader, and the harness finding a new cell's
files by name without an edit to any file it already has."""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size(root):
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  and not p.startswith("/")
                                                  for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(c) for c in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"]) and (root / word).is_file()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metric_entries():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in E2E


def test_each_listed_cell_reports_the_metric_its_per_layer_metric_moves():
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in CELLS
            assert w in E2E[m["moves"]].get("workloads", CELLS), (m["name"], w)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH, w, True)


def test_one_layer_name_per_layer_and_readers_agree():
    for m in BENCH["per_layer"]:
        mod = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
    for m in BENCH["end_to_end"]:
        assert callable(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read)


def test_each_cell_has_its_files(root):
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        conf = json.loads((root / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert conf["arch"]["name"] == c["name"]
    for w in CELLS.values():
        mix = harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")
        assert (harness.HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    used = {w["config"] for w in CELLS.values()}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.sim", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.sim"]


def _copy(root, tmp, with_program=True):
    dst = tmp / "checkout"
    shutil.copytree(root / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", dst / "BENCHMARK.json")
    if with_program:
        (dst / "src").mkdir()
        os.symlink(root / "src" / "repro_torch", dst / "src" / "repro_torch")
    return dst


def _python(code, cwd, **env):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, env={**os.environ, **env}, timeout=600)


def test_new_config_mix_metric_and_cell_are_found_by_name(root, tmp_path):
    dst = _copy(root, tmp_path)
    pb = dst / "perfbench"
    from repro_torch.configs import get_smoke
    conf = json.loads((pb / "configs" / "granite-moe-3b-a800m.json").read_text())
    conf["arch"] = dataclasses.asdict(get_smoke("zamba2-1.2b"))
    conf["name"] = conf["arch"]["name"] = "tiny-hybrid"
    (pb / "configs" / "tiny-hybrid.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "mixes" / "decode_backlog.json").read_text())
    mix.update(active_slots=4, max_len=32, total_pages=32, backlog=16, warmup_steps=2)
    (pb / "mixes" / "tiny_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "steps_seen.py").write_text(
        "UNIT, LAYER, MOVES = 'steps', 'serving engine loop', 'decode_tokens_per_s'\n\n"
        "def read(rec):\n    return float(rec['steps'])\n")
    (pb / "limits" / "tiny.decode.json").write_text(json.dumps({"mean_logit_gap": 10.0,
                                                                "pages_leaked": 0}))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-hybrid", "source": "test", "reduced": [],
                             "file": "perfbench/configs/tiny-hybrid.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.decode", "config": "tiny-hybrid",
                               "traffic": "tiny_mix", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_tokens_per_s":
            m["workloads"].append("tiny.decode")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "serving engine loop",
                               "moves": "decode_tokens_per_s", "workloads": ["tiny.decode"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python("""
        import json, sys, time
        sys.path[:0] = ['src', '.']
        from perfbench import harness
        r, _ = harness.run_cell('tiny.decode', 3, 0.0, True, 'cpu', time.perf_counter())
        print(json.dumps(r))
    """, dst)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["steps_seen"]["value"] == 4.0 and result["correct"]


def test_no_card_means_no_result(root, tmp_path):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "granite-moe.decode",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_checkout_without_the_program_means_no_result(root, tmp_path):
    dst = _copy(root, tmp_path, with_program=False)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "granite-moe.decode",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=dst,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_run_loads_neither_jax_nor_the_jax_package(root, workload):
    out = _python(f"""
        import sys, time
        sys.path[:0] = ['src', '.']
        from perfbench import harness
        from perfbench.tests.conftest import smoke
        harness.run_cell({workload!r}, 5, 0.0, True, 'cpu', time.perf_counter(),
                         sizes=smoke({workload!r}))
        print(harness.forbidden_modules(sys.modules))
    """, root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
