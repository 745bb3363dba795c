"""``BENCHMARK.json`` within the contract's characters and shapes, and
every configuration file holding what its entry says."""

import json
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for section, keys in KEYS.items():
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names))
        for e in b[section]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k])
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        # every cell reports setup_s, another end-to-end and a per-layer
        assert len([m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", cells)]) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


def test_configurations_hold_their_files():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size"))
            assert conf["published"][k] != conf[k]


def test_every_limit_names_its_readings():
    """Each limit lies between the readings it was set from."""
    b = bench()
    for w in b["workloads"]:
        f = json.loads((ROOT / "portbench" / "limits"
                        / f"{w['name']}.json").read_text())
        for name, limit in f["limits"].items():
            r = f["readings"][name]
            assert r["lower"] < limit < r["upper"], (w["name"], name)
