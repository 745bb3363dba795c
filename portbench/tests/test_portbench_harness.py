"""The harness finds a cell's configuration, traffic, limits and metric
readers by name, from files alone; and it refuses to run without a
card."""

import json
import shutil

from conftest import ROOT


def _throwaway(tmp_path):
    """A checkout holding the benchmark's files and one more cell, whose
    configuration, traffic mix, limits and per-layer metric are new
    files."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "mistral-7b.json").read_text())
    conf["num_hidden_layers"] = 4
    (tmp_path / "portbench" / "configs" / "throwaway.json").write_text(
        json.dumps(conf))
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "lora-sft-4k.json").read_text())
    traffic["rows"] = 1
    (tmp_path / "portbench" / "traffic" / "one-row.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench" / "limits" / "throwaway-cell.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (tmp_path / "portbench" / "metrics" / "tokens_seen.train.py").write_text(
        "def read(r):\n    return r.get('tokens') or None\n")
    bench["configs"].append({"name": "throwaway", "source": "x",
                             "file": "portbench/configs/throwaway.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "throwaway-cell",
                               "config": "throwaway", "traffic": "one-row",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "tokens_seen.train", "unit": "tokens",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "train_tokens_per_s",
                               "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_a_new_cell_is_found_from_files(tmp_path):
    from portbench import compare
    from portbench.arch import arch_of, read_config
    from portbench.run import applies, find_cell, load_reader

    bench = _throwaway(tmp_path)
    w, c, traffic = find_cell(tmp_path, bench, "throwaway-cell")
    assert traffic["rows"] == 1 and traffic["driver"] == "train_sft"
    a = arch_of(c["name"], read_config(tmp_path / c["file"]))
    assert a.layers == 4 and a.dim == 4096
    assert compare.load_limits(tmp_path, w["name"]) == {"loss_gap": 1.0}
    metric = bench["per_layer"][-1]
    assert applies(metric, "throwaway-cell")
    assert not applies(metric, "mistral-7b-lora-sft")
    assert load_reader(tmp_path, metric["name"])({"tokens": 7}) == 7
    assert load_reader(tmp_path, "step_mfu.train")({}) is None


def test_every_cell_has_its_files():
    from portbench import compare
    from portbench.arch import arch_of, read_config
    from portbench.run import find_cell, load_reader

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        _, c, traffic = find_cell(ROOT, bench, w["name"])
        assert (ROOT / "portbench" / "drivers"
                / f"{traffic['driver']}.py").exists()
        arch_of(c["name"], read_config(ROOT / c["file"]))
        assert compare.load_limits(ROOT, w["name"])
    for m in bench["per_layer"]:
        assert load_reader(ROOT, m["name"])({}) is None


def test_no_card_no_result(tmp_path, monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", "mistral-7b-lora-sft", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_unknown_cell_no_result(monkeypatch, capsys):
    from portbench import run

    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "kubeflow_rm_tpu_torch_x",
                        types.ModuleType("kubeflow_rm_tpu_torch_x"))
    assert "kubeflow_rm_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "kubeflow_rm_tpu.models",
                        types.ModuleType("kubeflow_rm_tpu.models"))
    assert run.forbidden_loaded() == ["kubeflow_rm_tpu"]
