"""The port's kube adapter (``deploy/kubeclient.KubeAPIServer``) against
its REST facade, held to JAX's on the same scripts: the adapter cases of
``tests/test_cache.py`` (the steady-state contract, ``wait_for_sync``
and the cache switch, the 410 relist), the client limiter of
``tests/test_ha.py``, the selector grammar and the shared watch buffer
of ``tests/test_watch_fanout.py``, and one trace across the HTTP hop
(``tests/test_tracing.py``). Each case runs in both packages; where a
result is compared, the port's must equal JAX's after the TPU→GPU key
map. Waits are on events or bounded polls, never on a fixed sleep.
"""

import threading
import time
import urllib.request

import pytest

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, RestCluster, cp_module, jax_switch_defaults, key_map,
    parity, reset_uids,
)

PKGS = ("port", "jax")
pkgs = pytest.mark.parametrize("pkg", PKGS)
#: a one-host slice of four cards (JAX's ``v5p-8``)
SLICE = {"port": "h100-80gb-4", "jax": "v5p-8"}


def _poll(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture
def cluster(request):
    """``(cluster, adapter)`` of the package the test is parametrised on,
    namespace ``u``."""
    pkg = request.node.callspec.params["pkg"]
    c = RestCluster(pkg)
    c.api.ensure_namespace("u")
    try:
        yield c, cp_module(pkg, "deploy.kubeclient").KubeAPIServer(c.url)
    finally:
        c.close()


def _cm(pkg, name, ns="u", **labels):
    o = cp_module(pkg, "api.meta").make_object("v1", "ConfigMap", name, ns)
    if labels:
        o["metadata"]["labels"] = labels
    return o


# ---- tests/test_cache.py: the adapter's informer cache -----------------

def _caught_up(kapi, api, kinds) -> bool:
    """The adapter's store holds every server object at its rv."""
    for kind in kinds:
        for o in api.list(kind):
            md = o["metadata"]
            ref = kapi.cache.get_ref(kind, md["name"], md.get("namespace"))
            if ref is None or ref["metadata"]["resourceVersion"] != \
                    md["resourceVersion"]:
                return False
    return True


def _steady_state(pkg):
    """A notebook spawned through the deployed layout (the cluster's
    kubelet in process, the platform over the adapter with a watch per
    ``WATCHED_KINDS``), then a resync of every controller: the writes
    the resync sent to the server."""
    m = cp_module(pkg, "")
    clock = FakeClock()
    c = RestCluster(pkg, clock=clock, admission=True, kubelet=True)
    stop = threading.Event()
    try:
        kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
            c.url, clock=clock)
        mgr = m.make_cluster_manager(kapi, enable_culling=False)
        # a write before the watches start: JAX's facade reads a resume
        # at rv 0 as none and would drop what lands before the watch
        # registers (C12, repaired in the port)
        c.api.ensure_namespace("user1")
        threads = [threading.Thread(target=kapi.watch_kind,
                                    args=(k, None, stop, 30), daemon=True)
                   for k in m.WATCHED_KINDS]
        for t in threads:
            t.start()
        assert kapi.wait_for_sync(m.WATCHED_KINDS, timeout=30)
        stc = cp_module(pkg, "controllers.statefulset")
        make_node = stc.make_tpu_node if pkg == "jax" else stc.make_gpu_node
        c.api.create(make_node("n0", SLICE[pkg]))
        kapi.create(cp_module(pkg, "api.notebook").make_notebook(
            "nb", "user1", accelerator_type=SLICE[pkg]))

        def settled():
            mgr.run_until_idle()
            c.kubelet.run_until_idle()
            nb = c.api.get("Notebook", "nb", "user1")
            return ((nb.get("status") or {}).get("readyReplicas") == 1
                    and _caught_up(kapi, c.api, m.WATCHED_KINDS)
                    and mgr.run_until_idle() == 0)
        assert _poll(settled, 30)
        before = len(c.api.write_log)
        mgr.enqueue_all()
        n = mgr.run_until_idle()
        assert n > 0  # the resync really did reconcile everything
        return list(c.api.write_log)[before:]
    finally:
        stop.set()
        c.close()


def test_steady_state_through_the_adapter_issues_zero_writes():
    """``tests/test_cache.py:279``'s contract on the deployed layout:
    once a notebook has converged, a resync of every controller reads
    from the adapter's informer store and writes nothing, in both
    packages."""
    assert [_steady_state(pkg) for pkg in PKGS] == [[], []]


@pkgs
def test_adapter_wait_for_sync_and_cache_disable(pkg, cluster):
    c, kapi = cluster
    assert kapi.wait_for_sync(["ConfigMap"], timeout=0.05) is False
    stop = threading.Event()
    t = threading.Thread(target=kapi.watch_kind,
                         args=("ConfigMap", None, stop, 2), daemon=True)
    t.start()
    try:
        assert kapi.wait_for_sync(["ConfigMap"], timeout=10) is True
        assert kapi.cache.is_synced("ConfigMap")
    finally:
        stop.set()
    # the no-cache arm: vacuous sync, cold store, reads fall through
    off = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
        c.url, cache_reads=False)
    assert off.wait_for_sync(["ConfigMap"], timeout=0) is True
    assert off.cache.is_synced("ConfigMap") is False
    c.api.create(_cm(pkg, "live"))
    assert [o["metadata"]["name"] for o in off.scan("ConfigMap", "u")] \
        == ["live"]


@pkgs
def test_adapter_410_relist_recovers_cache(pkg, cluster):
    c, kapi = cluster
    c.api.create(_cm(pkg, "one"))
    stop = threading.Event()
    # a one-second watch: the loop re-registers every second, and the
    # next rv-resume trips over the moved backlog horizon
    t = threading.Thread(target=kapi.watch_kind,
                         args=("ConfigMap", None, stop, 1), daemon=True)
    t.start()
    try:
        assert kapi.wait_for_sync(["ConfigMap"], timeout=10)
        assert kapi.get("ConfigMap", "one", "u")  # served by the store
        with c.rest._watch_lock:
            c.rest._backlog_floor = 10_000
        c.api.create(_cm(pkg, "two"))
        c.api.delete("ConfigMap", "one", "u")
        assert _poll(
            lambda: kapi.cache.get_ref("ConfigMap", "two", "u") is not None
            and kapi.cache.get_ref("ConfigMap", "one", "u") is None), \
            "the store did not converge after the 410-forced relist"
    finally:
        stop.set()


def test_delete_keeps_a_finalizing_object_in_the_store():
    """C14: a DELETE of an object with finalizers only marks it, and its
    MODIFIED event (the deletionTimestamp) may reach the adapter's store
    before the DELETE's reply. The port's store keeps that marked entry
    (the finalizing controller reads it); JAX's discards it and no later
    event brings it back. Then the finalizer's release deletes it from
    both."""
    def case(pkg):
        c = RestCluster(pkg)
        stop = threading.Event()
        try:
            c.api.ensure_namespace("u")
            kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(c.url)
            t = threading.Thread(target=kapi.watch_kind, daemon=True,
                                 args=("ConfigMap", None, stop, 30))
            t.start()
            assert kapi.wait_for_sync(["ConfigMap"], timeout=10)
            cm = _cm(pkg, "f")
            cm["metadata"]["finalizers"] = ["example.com/hold"]
            kapi.create(cm)

            def marked():
                ref = kapi.cache.get_ref("ConfigMap", "f", "u")
                return ref is not None and \
                    ref["metadata"].get("deletionTimestamp")
            # the reply waits until the watch has delivered the mark
            sess = kapi._session
            send = sess.delete
            sess.delete = lambda url, **kw: (
                send(url, **kw), _poll(marked))[0]
            kapi.delete("ConfigMap", "f", "u")
            kept = bool(marked())
            live = c.api.get("ConfigMap", "f", "u")
            live["metadata"]["finalizers"] = []
            c.api.update(live)
            assert _poll(lambda: c.api.try_get("ConfigMap", "f", "u")
                         is None
                         and kapi.cache.get_ref("ConfigMap", "f", "u")
                         is None)
            return kept
        finally:
            stop.set()
            c.close()
    assert (case("port"), case("jax")) == (True, False)


# ---- tests/test_ha.py: the client's limiter and identity ----------------

@pkgs
def test_kube_client_wires_limiter_and_identity(pkg):
    kc = cp_module(pkg, "deploy.kubeclient")
    api = kc.KubeAPIServer("http://127.0.0.1:1", qps=5.0, burst=7,
                           identity="mgr-0")
    assert (api.limiter.qps, api.limiter.burst, api.identity) == \
        (5.0, 7, "mgr-0")
    assert kc.KubeAPIServer("http://127.0.0.1:1").limiter is None
    assert api._session._headers["X-Writer-Identity"] == "mgr-0"


@pkgs
def test_kube_client_throttle_debits_limiter(pkg):
    kc = cp_module(pkg, "deploy.kubeclient")
    api = kc.KubeAPIServer("http://127.0.0.1:1", qps=100.0, burst=2)
    t = [0.0]
    api.limiter = kc.TokenBucket(qps=100.0, burst=2, clock=lambda: t[0],
                                 sleep=lambda s: None)
    for _ in range(3):
        api._throttle()
    assert api.limiter.throttled_calls == 1
    assert api.limiter.throttled_seconds == pytest.approx(0.01)


# ---- tests/test_watch_fanout.py: selectors and the shared buffer -------

def _selectors():
    return [
        {"matchLabels": {"tier": "web"}},
        {"matchExpressions": [
            {"key": "tier", "operator": "NotIn", "values": ["db"]}]},
        {"matchExpressions": [{"key": "env", "operator": "Exists"}]},
        {"matchExpressions": [{"key": "env", "operator": "DoesNotExist"}]},
        {"matchExpressions": [
            {"key": "tier", "operator": "In", "values": ["web", "db"]}]},
        {"matchExpressions": [
            {"key": "tier", "operator": "NotIn", "values": ["web", "db"]}]},
        {"matchLabels": {"env": "prod"}, "matchExpressions": [
            {"key": "tier", "operator": "NotIn", "values": ["db"]}]},
    ]


def test_selector_roundtrip_through_kubeclient():
    """Every selector form goes through the adapter's query string and
    the facade's parser to the same matches in both packages."""
    def case(pkg):
        c = RestCluster(pkg)
        try:
            c.api.quota_enforcement = False
            c.api.ensure_namespace("u")
            for name, labels in (("a", {"tier": "web", "env": "prod"}),
                                 ("b", {"tier": "db", "env": "prod"}),
                                 ("c", {"tier": "web"}), ("d", {})):
                c.api.create(_cm(pkg, name, **labels))
            kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(c.url)
            return [sorted(o["metadata"]["name"] for o in kapi.list(
                "ConfigMap", "u", label_selector=s)) for s in _selectors()]
        finally:
            c.close()
    port, jax = case("port"), case("jax")
    assert port == jax == [["a", "c"], ["a", "c", "d"], ["a", "b"],
                           ["c", "d"], ["a", "b", "c"], ["d"], ["a"]]


def _sorted_values(selector):
    """A selector with each expression's values sorted (the serializer
    writes them sorted)."""
    out = dict(selector)
    out["matchExpressions"] = [
        dict(e, **({"values": sorted(e["values"])} if "values" in e else {}))
        for e in selector.get("matchExpressions") or []]
    return out


def test_selector_query_string_parsing():
    """The facade's grammar and the adapter's serializer agree with
    JAX's, and each inverts the other."""
    raws = ["a=1,b==2", "tier!=db", "env", "!env",
            "tier in (web, db),env=prod", "tier notin (db),x"]
    parse = {pkg: cp_module(pkg, "deploy.restserver")._selector_from
             for pkg in PKGS}
    ser = {pkg: cp_module(pkg, "deploy.kubeclient")._selector_param
           for pkg in PKGS}
    for raw in raws:
        got = parse["port"]({"labelSelector": [raw]})
        assert got == parse["jax"]({"labelSelector": [raw]}), raw
        again = ser["port"](got)
        assert again == ser["jax"](got), raw
        back = parse["port"]({"labelSelector": [again["labelSelector"]]})
        assert _sorted_values(back) == _sorted_values(got), raw
    assert parse["port"]({"labelSelector": ["tier in (web, db),env=prod"]}) \
        == {"matchLabels": {"env": "prod"}, "matchExpressions": [
            {"key": "tier", "operator": "In", "values": ["web", "db"]}]}
    assert ser["port"](None) == {}


@pkgs
def test_watch_stream_single_encode_shares_buffer(pkg, cluster, parity):
    """Two concurrent watch streams of one kind receive the same
    (single-encode) bytes."""
    c, kapi = cluster
    results: dict[int, bytes] = {}

    def read_stream(idx):
        req = urllib.request.Request(
            f"{kapi.base_url}/api/v1/namespaces/u/configmaps"
            "?watch=true&timeoutSeconds=5")
        with urllib.request.urlopen(req, timeout=10) as resp:
            results[idx] = resp.readline()

    threads = [threading.Thread(target=read_stream, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    assert _poll(lambda: len(c.rest._watch_queues) == 2)
    c.api.create(_cm(pkg, "shared"))
    for t in threads:
        t.join(30)
    assert results[0] == results[1]
    import json
    evt = json.loads(results[0])
    assert (evt["type"], evt["object"]["metadata"]["name"]) == \
        ("ADDED", "shared")


# ---- tests/test_tracing.py: one trace across the HTTP hop ---------------

def test_http_hop_stays_one_trace():
    """The adapter sends its span's ``traceparent``; the facade opens a
    server span under it and the stored object carries the same trace.
    A request with no context mints no span. The server span is
    recorded after the response goes out, so it is awaited."""
    def case(pkg):
        tracing = cp_module(pkg, "tracing")
        col = tracing.collector()
        col.clear()
        tracing.set_enabled(True)
        c = RestCluster(pkg)
        try:
            c.api.ensure_namespace("ns")
            kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(c.url)
            with tracing.start_span("client-op") as client:
                kapi.create(_cm(pkg, "c", ns="ns"))

            def server_spans():
                return [s for s in col.spans() if s["kind"] == "server"]
            assert _poll(lambda: len(server_spans()) == 1), col.spans()
            server = server_spans()[0]
            assert server["trace_id"] == client.trace_id
            stored = c.api.get("ConfigMap", "c", "ns")
            assert tracing.context_of(stored).trace_id == client.trace_id
            kapi.list("ConfigMap", "ns")
            c.api.drain_watchers()
            assert len(server_spans()) == 1, \
                "a traceparent-less request minted a server span"
            return server["name"], server["attrs"]
        finally:
            c.close()
            tracing.set_enabled(False)
            col.clear()
    port, jax = case("port"), case("jax")
    assert port == key_map(jax) == (
        "POST /api/v1/namespaces/ns/configmaps", {"component": "restserver"})


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
