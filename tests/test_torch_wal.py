"""The port's write-ahead log and state directory (lws_tpu_torch/core/wal.py)
against the JAX package's (lws_tpu/core/wal.py), on the CPU.

Every case of tests/test_wal.py runs on both packages with the same inputs,
and what each leaves behind is compared: the objects restored after a
simulated kill -9, the records of `wal.jsonl` and the snapshot in
`state.json`. Normalized, and only these: `uid` (drawn at random by each
store) and the wall stamps `creation_timestamp`, `deletion_timestamp` and
`last_transition_time`. A state directory written by one package restores
into the other to the same manifests, uids included, and both packages
refuse the same corrupt journals. The real-process failover (kill -9 of
`python -m lws_tpu_torch serve`, a `--standby` takes over) is the port's
twin of tests/test_wal.py's, which JAX marks slow; the port's takes a few
seconds and stays in tier-1.
"""

from __future__ import annotations

import copy
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from lws_tpu import manifest as jmanifest
from lws_tpu.api import contract as jcontract
from lws_tpu.api.pod import Pod as JPod
from lws_tpu.api.pod import PodPhase as JPodPhase
from lws_tpu.core import serialize as jserialize
from lws_tpu.core import store as jstore
from lws_tpu.core import wal as jwal
from lws_tpu.runtime import ControlPlane as JControlPlane
from lws_tpu_torch import manifest as pmanifest
from lws_tpu_torch.api import contract as pcontract
from lws_tpu_torch.api.pod import Pod as PPod
from lws_tpu_torch.api.pod import PodPhase as PPodPhase
from lws_tpu_torch.core import serialize as pserialize
from lws_tpu_torch.core import store as pstore
from lws_tpu_torch.core import wal as pwal
from lws_tpu_torch.runtime import ControlPlane as PControlPlane
from tests.test_torch_cli import jax_planes_restored  # noqa: F401
from tests.test_torch_fleet import port_planes_restored  # noqa: F401

# Every test here leaves both packages' process planes as it found them.
pytestmark = pytest.mark.usefixtures("jax_planes_restored", "port_planes_restored")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = SimpleNamespace(name="jax", wal=jwal, store=jstore, serialize=jserialize, Pod=JPod,
                      PodPhase=JPodPhase, ControlPlane=JControlPlane, manifest=jmanifest,
                      contract=jcontract)
PORT = SimpleNamespace(name="port", wal=pwal, store=pstore, serialize=pserialize, Pod=PPod,
                       PodPhase=PPodPhase, ControlPlane=PControlPlane, manifest=pmanifest,
                       contract=pcontract)
SIDES = (JAX, PORT)
WALL = frozenset({"uid", "creation_timestamp", "deletion_timestamp", "last_transition_time"})


def normalize(x):
    if isinstance(x, dict):
        return {k: ("<normalized>" if k in WALL else normalize(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [normalize(v) for v in x]
    return x


def lws_doc(name: str = "sample", replicas: int = 3, size: int = 2,
            image: str = "img:v1") -> dict:
    """The LeaderWorkerSet of tests/test_wal.py (3 replicas of groups of 2,
    one image) as a manifest both packages read."""
    return {"apiVersion": "leaderworkerset.x-k8s.io/v1", "kind": "LeaderWorkerSet",
            "metadata": {"name": name},
            "spec": {"replicas": replicas, "leaderWorkerTemplate": {
                "size": size, "workerTemplate": {"spec": {"containers": [
                    {"name": "worker", "image": image}]}}}}}


def crash(sd) -> None:
    """Simulate kill -9: no final snapshot, no clean close — just the
    kernel-side effects (flock released; fsync'd WAL bytes on disk)."""
    if sd._store is not None:
        sd._store._journal = None
        sd._store = None
    os.close(sd._lock_fd)
    sd._lock_fd = None


def fresh_attached(side, path, **kw):
    store = side.store.Store()
    sd = side.wal.StateDir(str(path), **kw)
    sd.acquire()
    n = sd.attach(store)
    return store, sd, n


def on_disk(path) -> dict:
    """The state directory's journal records and snapshot, normalized."""
    wal = os.path.join(str(path), "wal.jsonl")
    snap = os.path.join(str(path), "state.json")
    out = {"wal": None, "snapshot": None}
    if os.path.exists(wal):
        with open(wal) as f:
            lines = f.read().splitlines()
        out["wal"] = []
        for line in lines:
            try:
                out["wal"].append(normalize(json.loads(line)))
            except ValueError:
                out["wal"].append(line)  # a torn or corrupted record, as written
    if os.path.exists(snap):
        with open(snap) as f:
            out["snapshot"] = normalize(json.load(f))
    return out


def both(tmp_path, fn) -> dict:
    """`fn(side, dir)` on each package in a directory of its own; the
    answers and the directories' contents must be equal. Returns the
    answers by package."""
    got = {}
    for side in SIDES:
        path = tmp_path / side.name
        path.mkdir()
        got[side.name] = (fn(side, path), on_disk(path))
    assert got["port"] == got["jax"]
    return {k: v[0] for k, v in got.items()}


def make_all_groups_ready(side, cp, name: str, max_rounds: int = 60) -> None:
    """lws_tpu/testing.py:make_all_groups_ready, the test playing kubelet."""
    for _ in range(max_rounds):
        cp.run_until_stable()
        pods = cp.store.list("Pod", "default",
                             labels={side.contract.SET_NAME_LABEL_KEY: name})
        flipped = False
        for pod in pods:
            if not pod.status.ready:
                pod.status.phase = side.PodPhase.RUNNING
                pod.status.ready = True
                pod.status.address = f"{pod.meta.name}.{pod.spec.subdomain}.default"
                cp.store.update_status(pod)
                flipped = True
        if not flipped:
            return
    raise AssertionError(f"{name} never settled after {max_rounds} rounds")


def manifests(side, store) -> dict:
    kinds = side.serialize._registry()
    return {k: sorted((side.manifest.to_manifest(o) for o in store.list(k)),
                      key=lambda m: (m["metadata"]["namespace"], m["metadata"]["name"]))
            for k in kinds}


# ---------------------------------------------------------------------------
# tests/test_wal.py's cases, on both packages


def test_acknowledged_writes_survive_crash(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path)
        for i in range(10):
            store.create(side.Pod(meta=side.store.new_meta(f"p{i}")))
        p3 = store.get("Pod", "default", "p3")
        p3.status.message = "updated"
        store.update_status(p3)
        store.delete("Pod", "default", "p7")
        expected = side.serialize.snapshot_store(store)
        journal = side.wal.replay_wal(os.path.join(str(path), "wal.jsonl"))
        crash(sd)

        store2, sd2, n = fresh_attached(side, path)
        assert n == 9
        assert side.serialize.snapshot_store(store2) == expected
        old_rv = store2.get("Pod", "default", "p3").meta.resource_version
        created = store2.create(side.Pod(meta=side.store.new_meta("p-new")))
        assert created.meta.resource_version > old_rv
        sd2.close()
        return n, normalize(journal), old_rv, created.meta.resource_version

    both(tmp_path, run)


def test_delete_cascade_is_journaled_per_object(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path)
        parent = store.create(side.Pod(meta=side.store.new_meta("leader")))
        child_meta = side.store.new_meta("worker")
        child_meta.owner_references = [side.store.owner_ref(parent)]
        store.create(side.Pod(meta=child_meta))
        store.delete("Pod", "default", "leader")
        crash(sd)

        records = side.wal.replay_wal(os.path.join(str(path), "wal.jsonl"))
        deletes = [r for r in records if r["op"] == "delete"]
        assert {d["name"] for d in deletes} == {"leader", "worker"}
        store2, sd2, _ = fresh_attached(side, path)
        assert store2.list("Pod") == []
        sd2.close()
        return normalize(records)

    both(tmp_path, run)


def test_torn_wal_tail_is_discarded(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path)
        store.create(side.Pod(meta=side.store.new_meta("whole")))
        crash(sd)
        with open(path / "wal.jsonl", "a") as f:
            f.write('{"op": "create", "kind": "Pod", "obj": {"meta": {"na')  # torn

        store2, sd2, _ = fresh_attached(side, path)
        names = [p.meta.name for p in store2.list("Pod")]
        assert names == ["whole"]
        sd2.close()
        return names

    both(tmp_path, run)


def test_corrupt_mid_wal_refuses_partial_replay(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path)
        store.create(side.Pod(meta=side.store.new_meta("a")))
        store.create(side.Pod(meta=side.store.new_meta("b")))
        crash(sd)
        lines = (path / "wal.jsonl").read_text().splitlines()
        assert len(lines) == 2
        lines[0] = lines[0][:20]  # corrupt a NON-final record
        (path / "wal.jsonl").write_text("\n".join(lines) + "\n")

        sd2 = side.wal.StateDir(str(path))
        sd2.acquire()
        with pytest.raises(side.wal.CorruptWalError) as e:
            sd2.attach(side.store.Store())
        sd2.close(final_snapshot=False)
        return str(e.value).replace(str(path), "<dir>")

    both(tmp_path, run)


def test_compaction_resets_wal_and_preserves_state(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path, compact_records=5)
        seen = []
        for i in range(23):
            store.create(side.Pod(meta=side.store.new_meta(f"p{i}")))
            seen.append(sd._wal_records)
        assert sd._wal_records <= 5
        expected = side.serialize.snapshot_store(store)
        crash(sd)
        store2, sd2, _ = fresh_attached(side, path)
        assert side.serialize.snapshot_store(store2) == expected
        sd2.close()
        return seen

    both(tmp_path, run)


def test_pending_write_survives_threshold_compaction(tmp_path):
    def run(side, path):
        store, sd, _ = fresh_attached(side, path, compact_records=3)
        for i in range(3):  # third append triggers compaction mid-write
            store.create(side.Pod(meta=side.store.new_meta(f"p{i}")))
        crash(sd)
        store2, sd2, _ = fresh_attached(side, path)
        names = sorted(p.meta.name for p in store2.list("Pod"))
        assert len(names) == 3
        sd2.close()
        return names

    both(tmp_path, run)


def test_flock_arbitration(tmp_path):
    def run(side, path):
        _, sd, _ = fresh_attached(side, path)
        other = side.wal.StateDir(str(path))
        assert other.locked_by_other()
        with pytest.raises(side.wal.StateLockedError) as e:
            other.acquire()
        crash(sd)
        assert not other.locked_by_other()
        other.acquire()
        other.close(final_snapshot=False)
        return str(e.value).replace(str(path), "<dir>")

    both(tmp_path, run)
    # One lock file arbitrates between the packages too: a directory held
    # by one refuses the other.
    for holder, other in ((JAX, PORT), (PORT, JAX)):
        path = tmp_path / f"{holder.name}-holds"
        _, sd, _ = fresh_attached(holder, path)
        with pytest.raises(other.wal.StateLockedError):
            other.wal.StateDir(str(path)).acquire()
        sd.close()


def test_failover_resumes_rolling_update(tmp_path):
    """The active control plane dies (kill -9 equivalent) mid-rolling-update;
    the successor restores from snapshot+WAL and completes the update."""
    def run(side, path):
        cp = side.ControlPlane()
        sd = side.wal.StateDir(str(path))
        sd.acquire()
        sd.attach(cp.store)
        cp.create(side.manifest.from_manifest(copy.deepcopy(lws_doc())))
        make_all_groups_ready(side, cp, "sample")
        lws = cp.store.get("LeaderWorkerSet", "default", "sample")
        for c in lws.spec.leader_worker_template.worker_template.spec.containers:
            c.image = "img:v2"
        cp.store.update(lws)
        cp.run_until_stable()  # mid-rollout
        mid = normalize(manifests(side, cp.store))
        crash(sd)

        cp2 = side.ControlPlane()
        sd2 = side.wal.StateDir(str(path))
        sd2.acquire()
        sd2.attach(cp2.store)
        cp2.resync()
        make_all_groups_ready(side, cp2, "sample")
        for i in range(3):
            pod = cp2.store.get("Pod", "default", f"sample-{i}")
            assert pod.spec.containers[0].image == "img:v2"
        lws = cp2.store.get("LeaderWorkerSet", "default", "sample")
        assert lws.status.updated_replicas == 3
        after = normalize(manifests(side, cp2.store))
        sd2.close()
        return mid, after

    both(tmp_path, run)


def test_replayed_update_refreshes_owner_index(tmp_path):
    """An update that drops a controller ownerReference, replayed from the
    WAL, must not leave a stale owner-index entry."""
    def run(side, path):
        store, sd, _ = fresh_attached(side, path)
        parent = store.create(side.Pod(meta=side.store.new_meta("boss")))
        child_meta = side.store.new_meta("kid")
        child_meta.owner_references = [side.store.owner_ref(parent)]
        child = store.create(side.Pod(meta=child_meta))
        child.meta.owner_references = []  # deliberate orphaning
        store.update(child)
        crash(sd)

        store2, sd2, _ = fresh_attached(side, path)
        store2.delete("Pod", "default", "boss")
        kept = store2.try_get("Pod", "default", "kid") is not None
        assert kept
        sd2.close()
        return kept

    both(tmp_path, run)


# ---------------------------------------------------------------------------
# One package's state directory, restored by the other


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_a_state_dir_restores_into_the_other_package(tmp_path, writer, reader):
    """A control plane of `writer` runs a rolling update under a state
    directory and dies mid-rollout, with writes in both the snapshot and the
    journal; `reader` restores it to the same manifests, uids and
    resourceVersions included, and finishes the rollout."""
    cp = writer.ControlPlane()
    sd = writer.wal.StateDir(str(tmp_path), compact_records=40)
    sd.acquire()
    sd.attach(cp.store)
    cp.create(writer.manifest.from_manifest(copy.deepcopy(lws_doc())))
    make_all_groups_ready(writer, cp, "sample")
    lws = cp.store.get("LeaderWorkerSet", "default", "sample")
    lws.spec.leader_worker_template.worker_template.spec.containers[0].image = "img:v2"
    cp.store.update(lws)
    cp.run_until_stable()
    assert sd._wal_records > 0 and os.path.exists(sd.snapshot_path)
    want = manifests(writer, cp.store)
    crash(sd)

    cp2 = reader.ControlPlane()
    sd2 = reader.wal.StateDir(str(tmp_path))
    sd2.acquire()
    n = sd2.attach(cp2.store)
    assert manifests(reader, cp2.store) == want
    assert n == sum(len(v) for v in want.values())
    cp2.resync()
    make_all_groups_ready(reader, cp2, "sample")
    assert cp2.store.get("LeaderWorkerSet", "default", "sample").status.updated_replicas == 3
    sd2.close()


# ---------------------------------------------------------------------------
# Real processes: kill -9 the active `serve`; the standby takes over.

LWS_YAML = """\
apiVersion: leaderworkerset.x-k8s.io/v1
kind: LeaderWorkerSet
metadata:
  name: ha-demo
spec:
  replicas: 2
  leaderWorkerTemplate:
    size: 2
"""


def _start_serve(state_dir, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", "lws_tpu_torch", "serve", "--port", "0",
         "--state-dir", str(state_dir), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )


def _wait_for(proc, marker: str, deadline: float = 60.0) -> str:
    end = time.time() + deadline
    while time.time() < end:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited rc={proc.returncode}")
            time.sleep(0.05)
            continue
        if marker in line:
            return line
    raise AssertionError(f"serve did not print {marker!r} in time")


def _port(line: str) -> int:
    """The port of 'serving on http://127.0.0.1:PORT'."""
    return int(line.rsplit(":", 1)[1].split()[0].strip("/"))


def _http(port, method, path, body=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _count_objects(port) -> int:
    return sum(len(_http(port, "GET", f"/apis/{kind}")) for kind in pserialize._registry())


def test_kill9_failover_between_real_processes(tmp_path):
    """tests/test_wal.py's real-process failover on the port's `serve`: the
    acknowledged apply survives kill -9, the standby prints the count of the
    objects it restored, and its reconcilers materialize the group pods."""
    state = tmp_path / "state"
    active = _start_serve(state)
    standby = None
    try:
        port_a = _port(_wait_for(active, "serving on"))
        applied = _http(port_a, "POST", "/apply", LWS_YAML.encode())
        assert applied["applied"] == ["LeaderWorkerSet/ha-demo"]

        # Hot spare: blocks on the flock until the active dies.
        standby = _start_serve(state, extra=("--standby",))
        time.sleep(1.0)  # standby reaches the flock wait
        assert standby.poll() is None

        # Kill at a quiet moment (the reconcilers done), so the count of
        # acknowledged objects is known: the standby must restore all of them.
        counts = []
        while len(counts) < 3 or len(set(counts[-3:])) > 1:
            counts.append(_count_objects(port_a))
            time.sleep(0.2)
        os.kill(active.pid, signal.SIGKILL)  # no goodbye, no final snapshot
        restored = _wait_for(standby, "restored ", deadline=60)
        assert restored.startswith(f"restored {counts[-1]} objects from {state} ")
        port_b = _port(_wait_for(standby, "serving on", deadline=60))

        objs = _http(port_b, "GET", "/apis/lws")
        assert [o["metadata"]["name"] for o in objs] == ["ha-demo"]
        deadline = time.time() + 30
        while time.time() < deadline:
            pods = _http(port_b, "GET", "/apis/pods")
            if len(pods) >= 2:
                break
            time.sleep(0.2)
        assert len(pods) >= 2
    finally:
        for proc in (active, standby):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
