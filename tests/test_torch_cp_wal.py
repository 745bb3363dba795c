"""The port's write-ahead log, snapshots and apiserver recovery (slice
7e-1), held to JAX's ``controlplane/persistence``: the eight cases of
``tests/test_wal.py`` on each package, and the cross-reads — the same
records framed by either package are the same bytes, and a log (or a
whole apiserver's WAL directory) written by either package replays
under the other's reader to the same records and the same store, rv
and write sequence.
"""

import importlib
import os
import shutil
import struct

import pytest

from kubeflow_rm_tpu.controlplane.persistence import wal as jax_wal
from kubeflow_rm_tpu_torch.controlplane.persistence import wal as port_wal

PKGS = ("port", "jax")


def _mod(pkg, name):
    root = "kubeflow_rm_tpu" if pkg == "jax" else "kubeflow_rm_tpu_torch"
    return importlib.import_module(f"{root}.controlplane.{name}")


def _obj(kind, name, ns="d", rv=1):
    meta = {"name": name, "resourceVersion": str(rv)}
    if ns is not None:
        meta["namespace"] = ns
    return {"apiVersion": "v1", "kind": kind, "metadata": meta}


def _append_n(wal, n, start=1):
    for i in range(start, start + n):
        wal.append({"seq": i, "rv": i, "verb": "CREATE",
                    "obj": _obj("Pod", f"p{i}", rv=i)})


def _frame_offsets(path):
    with open(path, "rb") as f:
        data = f.read()
    offs, off = [], 0
    while off < len(data):
        length, _ = struct.unpack_from("<II", data, off)
        offs.append(off)
        off += struct.calcsize("<II") + length
    return offs


# ---- frame semantics -------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_truncated_tail_record_is_ignored(tmp_path, pkg):
    w = _mod(pkg, "persistence.wal")
    wal = w.WriteAheadLog(str(tmp_path))
    _append_n(wal, 5)
    wal.close()
    [seg] = w.segment_paths(str(tmp_path))
    offs = _frame_offsets(seg)
    with open(seg, "r+b") as f:
        f.truncate(offs[4] + 11)
    assert [r["seq"] for r in w.iter_records(seg)] == [1, 2, 3, 4]
    with open(seg, "r+b") as f:
        f.truncate(offs[3] + 3)
    assert [r["seq"] for r in w.iter_records(seg)] == [1, 2, 3]


@pytest.mark.parametrize("pkg", PKGS)
def test_mid_log_crc_mismatch_halts_replay(tmp_path, pkg):
    w, p = _mod(pkg, "persistence.wal"), _mod(pkg, "persistence")
    wal = w.WriteAheadLog(str(tmp_path))
    _append_n(wal, 5)
    wal.close()
    [seg] = w.segment_paths(str(tmp_path))
    hdr = struct.calcsize("<II")
    with open(seg, "rb") as f:
        first_len = struct.unpack("<II", f.read(hdr))[0]
    off = hdr + first_len + hdr + 2
    with open(seg, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(w.WALCorruption) as ei:
        list(w.iter_records(seg))
    msg = str(ei.value)
    assert "CRC mismatch" in msg and os.path.basename(seg) in msg
    with pytest.raises(p.WALCorruption):
        p.Persistence(str(tmp_path)).recover(set())


@pytest.mark.parametrize("pkg", PKGS)
def test_group_commit_tickets_are_durable_on_return(tmp_path, pkg):
    w = _mod(pkg, "persistence.wal")
    wal = w.WriteAheadLog(str(tmp_path))
    _append_n(wal, 3)
    [seg] = w.segment_paths(str(tmp_path))
    assert [r["seq"] for r in w.iter_records(seg)] == [1, 2, 3]
    wal.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_rotate_and_compact_drop_closed_segments(tmp_path, pkg):
    w = _mod(pkg, "persistence.wal")
    wal = w.WriteAheadLog(str(tmp_path))
    _append_n(wal, 3)
    wal.rotate()
    _append_n(wal, 2, start=4)
    assert len(w.segment_paths(str(tmp_path))) == 2
    wal.compact()
    segs = w.segment_paths(str(tmp_path))
    assert len(segs) == 1
    assert [r["seq"] for r in w.iter_records(segs[0])] == [4, 5]
    wal.close()


# ---- snapshot + tail equivalence -------------------------------------

def _run_writes(api):
    api.ensure_namespace("d")
    for i in range(6):
        api.create(_obj("Pod", f"p{i}"))
    for i in range(3):
        pod = api.get("Pod", f"p{i}", "d")
        pod.setdefault("status", {})["phase"] = "Running"
        api.update_status(pod)
    api.delete("Pod", "p5", "d")


def _store_view(api):
    out = {}
    for kind in ("Namespace", "Pod"):
        for o in api.list(kind, None if kind == "Namespace" else "d"):
            out[(kind, o["metadata"].get("namespace"),
                 o["metadata"]["name"])] = o
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_plus_tail_equals_pure_wal_replay(tmp_path, pkg):
    P = _mod(pkg, "persistence").Persistence

    def tail(p):
        p.log(seq=9, rv=9, verb="CREATE", obj=_obj("Pod", "p9", rv=9))
        p.log(seq=10, rv=9, verb="DELETE", obj=_obj("Pod", "p1", rv=1))

    pure, snapped = str(tmp_path / "pure"), str(tmp_path / "snapped")
    p1 = P(pure)
    for i in range(1, 9):
        p1.log(seq=i, rv=i, verb="CREATE", obj=_obj("Pod", f"p{i}", rv=i))
    p1.close()
    shutil.copytree(pure, snapped)
    p2 = P(snapped)
    rec = p2.recover(set())
    p2.wal.rotate()
    p2.complete_snapshot(seq=rec.seq, rv=rec.rv,
                         objects=list(rec.objects.values()))
    tail(p2)
    p2.close()
    p1b = P(pure)
    tail(p1b)
    p1b.close()
    ra, rb = P(pure).recover(set()), P(snapped).recover(set())
    assert rb.snapshot_seq == 8 and ra.snapshot_seq == 0
    assert ra.objects == rb.objects
    assert ("Pod", "d", "p1") not in ra.objects
    assert (ra.rv, ra.seq) == (rb.rv, rb.seq) == (9, 10)


# ---- apiserver crash recovery ----------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_apiserver_recovers_store_and_resumes_rv(tmp_path, pkg):
    APIServer = _mod(pkg, "apiserver").APIServer
    api = APIServer(wal_dir=str(tmp_path))
    _run_writes(api)
    before, rv_before = _store_view(api), api._rv
    api.close_persistence()
    api2 = APIServer(wal_dir=str(tmp_path))
    assert _store_view(api2) == before and api2._rv == rv_before
    assert api2.try_get("Pod", "p5", "d") is None
    created = api2.create(_obj("Pod", "after"))
    assert int(created["metadata"]["resourceVersion"]) > rv_before
    api2.close_persistence()


@pytest.mark.parametrize("pkg", PKGS)
def test_replay_emits_no_duplicate_watch_events(tmp_path, pkg):
    APIServer = _mod(pkg, "apiserver").APIServer
    api = APIServer(wal_dir=str(tmp_path))
    _run_writes(api)
    api.close_persistence()
    events = []
    api2 = APIServer(wal_dir=str(tmp_path))
    api2.add_watcher(lambda et, obj, old=None: events.append(et), name="t")
    api2.drain_watchers()
    assert events == []
    api2.create(_obj("Pod", "fresh"))
    api2.drain_watchers()
    assert events == ["ADDED"]
    api2.close_persistence()


@pytest.mark.parametrize("pkg", PKGS)
def test_no_wal_arm_has_no_persistence(tmp_path, pkg):
    api = _mod(pkg, "apiserver").APIServer()
    assert api._persistence is None
    api.ensure_namespace("d")
    api.create(_obj("Pod", "p0"))
    assert os.listdir(tmp_path) == []


# ---- cross-reads: each package replays the other's log ----------------

def _records():
    return [{"seq": i, "rv": i, "verb": "CREATE" if i % 3 else "DELETE",
             "obj": _obj("Pod", f"p{i // 2}", rv=i)} for i in range(1, 12)]


def test_frames_are_byte_identical():
    for r in _records() + [{"seq": 1, "obj": {"ü": "ä", "n": [1.5, None]}}]:
        payload = port_wal.json.dumps(r, separators=(",", ":")).encode()
        assert port_wal.encode_frame(payload) == \
            jax_wal.encode_frame(payload)


@pytest.mark.parametrize("writer", PKGS)
def test_each_package_replays_the_others_log(tmp_path, writer):
    """The same records appended by both packages make the same segment
    bytes; the reader of the other package yields the same records, and
    its ``Persistence.recover`` the same objects, rv and seq."""
    reader = "jax" if writer == "port" else "port"
    dirs = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    for pkg in PKGS:
        wal = _mod(pkg, "persistence.wal").WriteAheadLog(dirs[pkg],
                                                         fsync=False)
        for r in _records():
            wal.append(r)
        wal.rotate()
        wal.append({"seq": 12, "rv": 12, "verb": "CREATE",
                    "obj": _obj("Pod", "last", rv=12)})
        wal.close()
    rw = _mod(reader, "persistence.wal")
    segs = {pkg: _mod(pkg, "persistence.wal").segment_paths(dirs[pkg])
            for pkg in PKGS}
    assert [os.path.basename(s) for s in segs["port"]] == \
        [os.path.basename(s) for s in segs["jax"]]
    for a, b in zip(segs["port"], segs["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    got = [r for s in segs[writer] for r in rw.iter_records(s)]
    assert got == _records() + [{"seq": 12, "rv": 12, "verb": "CREATE",
                                 "obj": _obj("Pod", "last", rv=12)}]
    rec_other = _mod(reader, "persistence").Persistence(
        dirs[writer]).recover(set())
    rec_own = _mod(writer, "persistence").Persistence(
        dirs[writer]).recover(set())
    assert rec_other.objects == rec_own.objects
    assert (rec_other.rv, rec_other.seq, rec_other.records_replayed) == (
        rec_own.rv, rec_own.seq, rec_own.records_replayed)


@pytest.mark.parametrize("writer", PKGS)
def test_each_apiserver_recovers_the_others_store(tmp_path, writer):
    """An apiserver of one package writes (and snapshots part of) its
    history; the other package's apiserver boots from the directory to
    the same store, rv and Event sequence, and keeps writing."""
    reader = "jax" if writer == "port" else "port"
    api = _mod(writer, "apiserver").APIServer(wal_dir=str(tmp_path))
    _run_writes(api)
    assert api.snapshot_now()
    api.record_event(api.get("Pod", "p0", "d"), "Normal", "Probe", "x")
    before, rv = _store_view(api), api._rv
    events = api.list("Event", "d")
    api.close_persistence()
    other = _mod(reader, "apiserver").APIServer(wal_dir=str(tmp_path))
    try:
        assert _store_view(other) == before and other._rv == rv
        assert other.list("Event", "d") == events
        ev = other.record_event(other.get("Pod", "p1", "d"), "Normal",
                                "Probe", "y")
        assert ev["metadata"]["name"] not in {
            e["metadata"]["name"] for e in events}
        assert int(other.create(_obj("Pod", "next"))["metadata"][
            "resourceVersion"]) > rv
    finally:
        other.close_persistence()
