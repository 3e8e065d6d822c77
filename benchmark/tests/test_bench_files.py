"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and entries only are picked up, with no edit of the harness."""
import json
import os

from benchmark import spec


def test_new_cell_mix_and_metric_from_files(root, run_cell):
    with open(os.path.join(root, "benchmark", "traffic", "chat.json")) as f:
        mix = json.load(f)
    mix.update(rate_rps=3.0, size_seed=99)
    with open(os.path.join(root, "benchmark", "traffic", "slow.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "requests_done.py"), "w") as f:
        f.write("def read(w):\n    return sum(r.finished for r in w.due())\n")
    with open(os.path.join(root, "benchmark", "configs",
                           "tiny-qwen.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-qwen-b"
    with open(os.path.join(root, "benchmark", "configs",
                           "tiny-qwen-b.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-qwen-b", "source": "tiny",
                             "file": "benchmark/configs/tiny-qwen-b.json",
                             "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "tiny-qwen-b.slow",
                               "config": "tiny-qwen-b", "traffic": "slow",
                               "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "admission", "moves": "itl_p99_ms",
                               "workloads": ["tiny-qwen-b.slow"]})
    for met in bench["end_to_end"]:
        if met["name"] == "itl_p99_ms":
            met["workloads"].append("tiny-qwen-b.slow")
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny-qwen-b.slow", root)
    assert cell.traffic["rate_rps"] == 3.0
    assert [m["name"] for m in cell.per_layer] == ["requests_done"]
    rc, res, err = run_cell("tiny-qwen-b.slow", trace=1)
    assert rc == 0, err
    assert res["correct"]
    assert res["metrics"]["requests_done"]["value"] >= 1
    assert res["attempted"] == 9
