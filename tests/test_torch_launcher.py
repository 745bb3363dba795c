"""The port's launcher (``kubeflow_rm_tpu_torch/launcher``): the TPUJob
role env and the worker agent held to JAX's (``launcher/agent.py``) on
the webhook's env cases, the per-card torchrun env
(``launcher/torchrun.py``, the counterpart of ``launcher/torchxla.py``),
and a world of two agents on gloo that answer ``/healthz``."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from kubeflow_rm_tpu.controlplane.api import tpujob as jtj
from kubeflow_rm_tpu.launcher import agent as jagent
from kubeflow_rm_tpu.launcher.torchxla import torchxla_env
from kubeflow_rm_tpu_torch.controlplane.api import tpujob as ttj
from kubeflow_rm_tpu_torch.launcher import agent as tagent
from kubeflow_rm_tpu_torch.launcher import torchrun

ROOT = Path(__file__).resolve().parents[1]

ROLE_ENV = {
    jtj.ENV_JOB_NAME: "pr",
    jtj.ENV_JOB_ROLE: "actors",
    jtj.ENV_JOB_ROLE_INDEX: "3",
    jtj.ENV_JOB_ROLE_HOSTNAMES: "a-0.x,a-1.x",
    jtj.ENV_JOB_HOSTNAMES_PREFIX + "LEARNER": "l-0.x,l-1.x",
    jtj.ENV_JOB_HOSTNAMES_PREFIX + "EVAL_ACTORS": "e-0.x",
    jtj.ENV_LEARNER_ADDRESS: "l-0.x",
}
SINGLE_HOST = {  # what the webhook writes for a single-host slice
    "TPU_WORKER_ID": "0",
    "TPU_WORKER_HOSTNAMES": "nb-0.nb-workers.team.svc.cluster.local",
    "TPU_ACCELERATOR_TYPE": "h100-80gb-4",
    "TPU_TOPOLOGY": "4",
}
HOST_1 = {  # host 1 of a 2-host slice
    "TPU_WORKER_ID": "1",
    "TPU_WORKER_HOSTNAMES": "nb-0.nb-workers,nb-1.nb-workers",
    "TPU_ACCELERATOR_TYPE": "v5p-16",
    "TPU_TOPOLOGY": "2x2x2",
}
MULTISLICE = dict(HOST_1, MEGASCALE_NUM_SLICES="2", MEGASCALE_SLICE_ID="1",
                  MEGASCALE_COORDINATOR_ADDRESS="nb-0.nb-workers:8080")

ENV_CASES = {
    "gang actor": ROLE_ENV,
    "bad index": {jtj.ENV_JOB_NAME: "j",
                  jtj.ENV_JOB_ROLE_INDEX: "not-a-number"},
    "empty": {},
    "chip member": {jtj.ENV_JOB_NAME: "pr", jtj.ENV_JOB_ROLE: "learner",
                    "TPU_ACCELERATOR_TYPE": "v5p-16", "TPU_WORKER_ID": "0",
                    "TPU_WORKER_HOSTNAMES": "h0"},
    "single host": SINGLE_HOST,
    "host 1": HOST_1,
    "multislice": MULTISLICE,
}


def test_env_names_are_jaxs():
    for name in ("ENV_JOB_NAME", "ENV_JOB_ROLE", "ENV_JOB_ROLE_INDEX",
                 "ENV_JOB_ROLE_HOSTNAMES", "ENV_JOB_HOSTNAMES_PREFIX",
                 "ENV_LEARNER_ADDRESS", "KIND"):
        assert getattr(ttj, name) == getattr(jtj, name)


@pytest.mark.parametrize("case", ENV_CASES)
def test_role_env_and_agent_match_jax(case):
    env = ENV_CASES[case]
    assert dataclasses.asdict(tagent.role_env(env)) == \
        dataclasses.asdict(jagent.role_env(env))
    assert tagent.role_env(env).in_gang == jagent.role_env(env).in_gang
    mine, theirs = tagent.WorkerAgent(env), jagent.WorkerAgent(env)
    assert mine.is_actor == theirs.is_actor
    assert mine.is_worker_zero == theirs.is_worker_zero
    assert tagent.dict_env(mine.env) == jagent.dict_env(theirs.env)


def test_worker_zero_is_card_zero_of_rank_zero():
    assert tagent.WorkerAgent(SINGLE_HOST).is_worker_zero
    assert not tagent.WorkerAgent(SINGLE_HOST, local_rank=1).is_worker_zero
    assert not tagent.WorkerAgent(dict(SINGLE_HOST,
                                       LOCAL_RANK="2")).is_worker_zero
    assert not tagent.WorkerAgent(HOST_1).is_worker_zero
    # a host's agents serve /healthz on ports of their own
    assert tagent.WorkerAgent(SINGLE_HOST, local_rank=3).health_port == \
        tagent.HEALTH_PORT + 3


@pytest.mark.parametrize("case,cards,local,rank,world,master", [
    ("single host", 4, 2, 2, 4, "nb-0.nb-workers.team.svc.cluster.local"),
    ("host 1", 8, 3, 11, 16, "nb-0.nb-workers"),
    ("multislice", 4, 1, 13, 16, "nb-0.nb-workers"),
])
def test_torchrun_env_per_card(case, cards, local, rank, world, master):
    m = torchrun.torchrun_env(ENV_CASES[case], cards_per_host=cards,
                              local_rank=local)
    assert m == {"MASTER_ADDR": master,
                 "MASTER_PORT": str(torchrun.DEFAULT_MASTER_PORT),
                 "RANK": str(rank), "LOCAL_RANK": str(local),
                 "WORLD_SIZE": str(world)}


@pytest.mark.parametrize("case", ["single host", "host 1", "multislice"])
def test_one_card_a_host_is_torchxla_world(case):
    """At one card a host the port's world is JAX's torch_xla world: the
    same ranks, world, master and port."""
    want = torchxla_env(ENV_CASES[case])
    want.pop("PJRT_DEVICE")
    assert torchrun.torchrun_env(ENV_CASES[case], cards_per_host=1) == want


def test_torchrun_env_reads_local_rank_and_refuses_violations(monkeypatch):
    m = torchrun.torchrun_env(dict(HOST_1, LOCAL_RANK="5"),
                              cards_per_host=8)
    assert (m["RANK"], m["LOCAL_RANK"]) == ("13", "5")
    with pytest.raises(ValueError, match="outside"):
        torchrun.torchrun_env(dict(HOST_1, TPU_WORKER_ID="2"),
                              cards_per_host=8)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        torchrun.torchrun_env(SINGLE_HOST, cards_per_host=4, local_rank=4)
    with pytest.raises(ValueError, match="cards_per_host"):
        torchrun.torchrun_env(SINGLE_HOST, cards_per_host=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cards_per_host"):
        torchrun.torchrun_env(SINGLE_HOST)


def test_init_distributed_joins_a_gloo_world_of_one(monkeypatch):
    import torch.distributed as dist

    # set, then delete: the teardown removes what apply_env sets
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    env = dict(SINGLE_HOST, TPU_WORKER_HOSTNAMES="localhost")
    d = torchrun.init_distributed(env, device="cpu", cards_per_host=1,
                                  master_port=_free_port())
    try:
        assert d.get_rank() == 0 and d.get_world_size() == 1
        t = torch.tensor([21.0])
        d.all_reduce(t)
        assert float(t) == 21.0
        assert torchrun.init_distributed(env, device="cpu",
                                         cards_per_host=1) is None
    finally:
        dist.destroy_process_group()


def test_health_server_is_503_until_joined():
    agent = tagent.WorkerAgent(SINGLE_HOST, health_port=0)
    port = agent.start_health_server()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        assert e.value.code == 503
        body = json.loads(e.value.read())
        assert body == {"ready": False, "worker_id": 0, "local_rank": 0,
                        "hosts": 1}
    finally:
        agent._httpd.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


AGENT = textwrap.dedent("""\
    import json, sys, urllib.request
    import torch
    import torch.distributed as dist
    from kubeflow_rm_tpu_torch.launcher.agent import WorkerAgent

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    env = {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "localhost",
           "TPU_ACCELERATOR_TYPE": "h100-80gb-4", "LOCAL_RANK": str(rank)}
    agent = WorkerAgent(env, cards_per_host=2, device="cpu",
                        health_port=0, master_port=port)
    hport = agent.start_health_server()
    agent.join_slice(retry_interval_s=1.0, max_attempts=30)
    with urllib.request.urlopen(f"http://127.0.0.1:{hport}/healthz",
                                timeout=10) as r:
        status, body = r.status, json.loads(r.read())
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    print(json.dumps({"status": status, "body": body,
                      "rank": dist.get_rank(),
                      "world": dist.get_world_size(), "sum": float(t)}))
    agent._httpd.shutdown()
""")


def test_two_agents_form_a_gloo_world_and_answer_healthz():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", AGENT, str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, o in enumerate(outs):
        assert o["status"] == 200
        assert o["body"] == {"ready": True, "worker_id": 0,
                             "local_rank": r, "hosts": 1}
        assert (o["rank"], o["world"], o["sum"]) == (r, 2, 3.0)
