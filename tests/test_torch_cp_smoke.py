"""The smoke's ``controlplane`` phase rehearsed on the CPU at a tiny
declaration: arm A on the raw read path (spawn, stop, delete) and arm B
on ``make_control_plane``'s defaults — a profile with a one-card quota,
the image table, a PodDefault, the notebook (the lock, the resolved
image, the oauth sidecar, the auth companion's objects, the card and
the PodDefault's variable), the pod's fine-tune in a child process on a
one-rank gloo world, the quota's refusal, a failed pod restarted, the
idle notebook culled through the default probe against a standard-
library server, a TPUJob on the freed card, and the teardown — with the
jupyter and KFAM web apps served over arm B's apiserver on a threaded
``wsgiref`` server: a readiness long-poll parked before the spawn
reconciles and woken by the hub until ``ready``, the spawner's listing,
pods and types, KFAM's contributor spawning ``ft2`` through the form
into the quota's refusal, a stranger's 403, ``stopped`` after the cull,
and the deletes through the app; then arm C
on the suspend/resume stack with a checkpoint store over the pod's
directory — the fine-tune checkpoints step 2 and holds in step 3, a
high-priority notebook preempts it at step 2, its child is SIGKILLed,
the resume re-binds it once the other is suspended, and the new child
runs step 3 alone, its loss equal to arm B's uninterrupted step 3 bit
for bit; then arm D, the deployed layout on a gloo world — two sharded
apiservers behind REST facades, the manager over the shard router under
a leader election, the notebook spawned on the shard that owns its
namespace, the webhook server's patch equal to what the cluster stored,
the pod's one step equal to arm B's step 1 bit for bit, the owning
shard restarted in place from its WAL with the same uids and
resourceVersions and no second pod, and a teardown that leaves nothing;
then arm E, the shards as real processes under ``ShardRunner`` — a split
under the ``shard_split`` chaos arm (a donor SIGKILLed mid-handoff and
respawned) while a writer creates pods in moving namespaces, the
notebook's shard SIGKILLed and respawned from its WAL with the same
uids and resourceVersions, the pod's one step equal to arm B's step 1,
a merge that is not a death, the zero-loss audit after both handoffs,
and no worker left after ``stop()`` — all of it watched by a real
``Observer``: its TSDB federating the three shard processes, its flight
recorder taking the chaos trigger and the supervisor's death hook (each
death a ``shard_death`` bundle or a suppression; the owner's bundle
whole, with slow traces from this process and the shards whose critical
paths sum to their durations), and a ``ShardAutoscaler`` making the
merge on the federated queue depth; then arm F, the platform as its
manifests deploy it — ``controller-manager`` (under ``LEADER_ELECT``),
``webhook-server`` and ``gateway`` (``DEV_USER``) as ``python -m
kubeflow_rm_tpu_torch.controlplane`` processes over one shard's facade:
the SPA's shell and ``app.js``, the workgroup, the spawner's form spawn
read ``ready`` through the long-poll, the webhook process's review equal
to the in-process handler's, the pod's one step equal to arm B's step 1,
the dashboard's metrics, history, alerts, harvest and traces, no torch
in the three processes, and each exiting 0 on SIGTERM. Every gate of the
phase holds, as on the card."""

import json
import socket

from tests.torch_cp_parity import DEFAULT_SWITCHES, jax_switch_defaults

TINY = {"preset": "tiny", "optim": "adamw", "batch": 2, "grad_accum": 1,
        "remat": "dots", "seq": 128, "lora_rank": 4}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_controlplane_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    import chip_smoke

    # the child's rendezvous port: one of its own, beside other worlds
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    launches = chip_smoke.phase_controlplane("cpu", device="cpu",
                                             decl=TINY, steps=3)
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"phase": "controlplane"')]
    a, b = line["arm_a"], line["arm_b"]
    assert a["stopped"] == {"replicas": 0, "pods": 0, "free_cards": 1.0}
    assert list(b["steps_s"]) == [
        "profile", "images_poddefault", "spawn", "kfam_binding", "quota",
        "quota_delete", "slice_health", "cull", "tpujob", "tpujob_delete",
        "teardown"]
    # the web apps over arm B's apiserver: the spawner's long-poll woken
    # by the hub and read ready, KFAM's binding counted, every request
    # timed
    lp = b["longpoll"]
    assert lp["wakes"] >= 1 and lp["waiters_after"] == 0
    assert lp["wake_to_observe_s"] >= 0 and lp["park_s"] > 0
    assert lp["polls"][-1]["ready"] is True
    assert lp["polls"][-1]["phase"] == "ready"
    assert all(p["status"] == 200 for p in lp["polls"])
    assert b["kfam"]["create_binding_success"] == 1
    assert b["kfam"]["read_bindings_success"] == 1
    assert not any(v for k, v in b["kfam"].items() if k.endswith("_error"))
    assert {"readiness", "list", "pods", "tpus", "kfam_binding",
            "kfam_bindings", "spawn_form", "stranger", "delete"} == set(
                b["web_s"])
    assert len(b["web_s"]["list"]) == 2 and len(b["web_s"]["delete"]) == 2
    assert all(0 < t < 60 for ts in b["web_s"].values() for t in ts)
    assert b["culled"]["culls"] == 1 and b["culled"]["probe_gets"] > 0
    assert b["restarted"] == {"new_uid": True, "node": "gpu-0",
                              "phase": "Running", "free_cards": 0.0}
    assert b["cache_hit_ratio"] > 0.9
    assert line["pod_workload"]["poddefault"] == "smoke"
    assert line["pod_workload"]["world"]["backend"] == "gloo"
    c, losses = line["arm_c"], line["pod_workload"]["losses"]
    assert list(c["steps_s"]) == ["profile", "spawn", "preempt",
                                  "resume_parked", "rebind", "teardown"]
    assert c["preempted"]["reason"] == "preempted"
    assert c["preempted"]["token"] == {"step": 2}
    assert c["killed_rc"] == -9 and c["restored_step"] == "2"
    assert c["first_child"]["losses"][:2] == losses[:2]
    assert c["resumed_child"]["steps"] == [3]
    assert c["resumed_child"]["losses"] == losses[2:]
    assert c["counters"]["preempt"] == 1 and c["counters"]["resume"] == 1
    assert len(c["checkpoint_save_s"]) == 2
    assert len(c["checkpoint_restore_s"]) == 1
    assert c["checkpoint_bytes"]["2"] > 0 and c["checkpoint_bytes"]["3"] > 0
    d = line["arm_d"]
    assert d["owner"] != d["lease_shard"]
    assert all(v == [d["owner"]] for v in d["placed"].values())
    assert d["child"]["steps"] == [1] and d["child"]["losses"] == losses[:1]
    assert d["recovered"] == {"Notebook": True, "StatefulSet": True,
                              "Pod": True}
    assert "Pod" in d["relisted"] and "Notebook" in d["relisted"]
    assert all(n > 0 for n in d["rest_requests"].values())
    assert list(d["steps_s"]) == ["profile", "spawn", "webhook_review",
                                  "delete", "teardown"]
    e = line["arm_e"]
    assert list(e["steps_s"]) == ["start", "profile", "spawn", "split",
                                  "federate", "owner_wait", "merge",
                                  "autoscale", "teardown"]
    assert e["split"]["shard"] == "shard-2" == e["merge"]["shard"]
    assert e["split"]["objects_bulk"] > 0 and e["merge"]["objects_bulk"] > 0
    assert e["chaos_victim"] in ("shard-0", "shard-1")
    assert e["recovered"] == {"Notebook": True, "StatefulSet": True,
                              "Pod": True}
    assert e["deaths"] == 1
    assert e["written"] > 0
    assert e["audited"] == [36 + e["written"]] * 2
    assert e["child"]["steps"] == [1] and e["child"]["losses"] == losses[:1]
    assert e["cuda_gate"] == {"split": None, "child": None}
    # two at the start, the split's new shard and two respawns
    assert len(e["pids"]) >= 5
    sup = e["counters"]["supervisor"]
    assert sup["shard_splits_total"] >= 1 and sup["shard_merges_total"] >= 1
    assert sup["shard_deaths_total"] >= 2
    # the observer: the chaos donor's death and the owner's, each a
    # bundle or a suppression, the owner's a bundle
    o = e["observer"]
    assert o["deaths"] == 2
    assert {"shard": e["owner"], "exitcode": -9} in o["death_bundles"]
    assert o["deaths"] - len(o["death_bundles"]) <= o["suppressed"]
    assert o["shard_deaths_before_kill"] == "critical"
    b = o["owner_bundle"]
    assert b["slow_traces"] >= 1 and "coordinator" in b["processes"]
    assert all(abs(d - p) <= 1.0 for d, p in b["duration_vs_path_ms"])
    assert {"shard-0", "shard-1", "shard-2"} - {e["owner"]} <= \
        set(b["instances"])
    assert [d["decision"] for d in o["decisions"]][-1] == "merge"
    assert not {"split", "carve"} & {d["decision"] for d in o["decisions"]}
    assert sorted(o["federated"]) == ["shard-0", "shard-1", "shard-2"]
    assert o["drift"] is None and o["drift_state"] == "ok"
    assert {n for n, st in o["not_ok"].items() if st == "critical"} <= {
        "shard-deaths"}
    assert o["tsdb"]["series"] > 0 and o["tsdb"]["evictions"] == 0
    assert o["ticks"] > 0 and o["flight"]["triggered_total"] >= 2
    f = line["arm_f"]
    assert list(f["steps_s"]) == ["profile", "spawn", "webhook_review",
                                  "delete", "teardown"]
    procs = ("controller-manager", "webhook-server", "gateway")
    assert sorted(f["start_s"]) == sorted(procs)
    assert f["torch_loaded"] == dict.fromkeys(procs, False)
    assert f["torch_control"] is True
    assert f["exits"] == dict.fromkeys(procs, 0)
    assert f["child"]["steps"] == [1] and f["child"]["losses"] == losses[:1]
    assert f["metrics"] == {"nodes": 1, "chips_capacity": 1.0,
                            "chips_requested": 1.0, "notebooks_running": 1}
    assert f["env_info"]["tpuSliceTypes"] == ["h100-80gb-1"]
    assert f["series"] >= 1 and "shard-deaths" in f["slos"]
    assert f["traces"]["enabled"] is False and f["traces"]["slow"] == []
    assert f["polls"][-1]["ready"] is True
    assert f["polls"][-1]["phase"] == "ready"
    assert f["review"]["allowed"] is True and f["review"]["uid"] == "smoke-f"
    assert {"shell", "app_js", "workgroup_create", "env_info", "config",
            "tpus", "spawn_form", "readiness", "metrics", "history",
            "alerts", "harvest", "traces", "delete"} == set(f["web_ms"])


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
