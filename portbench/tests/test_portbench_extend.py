"""A new traffic mix is data only: a copy of the benchmark with one more
traffic file and one more ``workloads`` entry (and the limits file of the
new cell) runs the new cell, with no file of the copy edited but
``BENCHMARK.json``."""
import json
import shutil
import subprocess
import sys


def test_new_traffic_file_runs_as_a_cell(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(root / "src")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    short = {"driver": "serve", "callers": 8,
             "prompt_len": {"dist": "loguniform", "lo": 64, "hi": 1024},
             "max_new": {"dist": "uniform", "lo": 1, "hi": 8}, "pool": 8,
             "serve": {"max_batch": 8, "prompt_buckets": [256, 1024],
                       "max_batch_delay_ms": 20, "max_new_cap": 8},
             "check_requests": 8, "drain_seconds": 60, "trace_seconds": 3,
             "cpu_test": {"callers": 2, "prompt_len": {"lo": 8, "hi": 32},
                          "max_new": {"lo": 1, "hi": 3}, "pool": 4,
                          "serve": {"max_batch": 2, "prompt_buckets": [32],
                                    "max_new_cap": 4},
                          "check_requests": 2, "trace_seconds": 1}}
    (tmp_path / "portbench/traffic/chat-short.json").write_text(
        json.dumps(short))
    (tmp_path / "portbench/limits/internlm2.chat-short.json").write_text(
        (root / "portbench/limits/internlm2.docs.json").read_text())
    bench["workloads"].append({
        "name": "internlm2.chat-short", "config": "internlm2-1.8b",
        "traffic": "chat-short", "chips": 1, "why": "a test's extra cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "internlm2.docs" in m.get("workloads", ()):
            m["workloads"].append("internlm2.chat-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import sys, json, pathlib; sys.path[:0] = ['.', 'src']\n"
            "from portbench import run\n"
            "line = run.run_cell(pathlib.Path('.'), 'internlm2.chat-short', "
            "7, 1.5, False, device='cpu', test_size=True)\n"
            "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] > 0
    new = "internlm2.chat-short"
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                    if new in m.get("workloads", [new])}
    assert {p.name for p in (root / "portbench/traffic").iterdir()} == {
        p.name for p in (tmp_path / "portbench/traffic").iterdir()} - {
        "chat-short.json"}
