"""LocalBackend: runs pods as real local processes.

The "kubelet" of single-host deployments and e2e tests: when a pod appears it
spawns the container's command with the pod's injected env (the full
LWS_*/TPU_*/JAX_* bootstrap contract), marks the pod Running+ready, tracks the
process, and reports exits back into pod status — a Failed exit increments
container_restarts, which is exactly what trips the all-or-nothing restart
policy (SURVEY §3.5) for real workloads.

FQDN rewriting: rendezvous names like `<leader>.<subdomain>.<ns>` resolve via
cluster DNS in a fleet; locally every pod is on this host, so values of
address-bearing env vars get their host part rewritten to 127.0.0.1.

The port's copy of lws_tpu/runtime/local.py.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Optional

from lws_tpu_torch.api import contract
from lws_tpu_torch.api.pod import Pod, PodPhase
from lws_tpu_torch.core.manager import Result
from lws_tpu_torch.core.store import Key, Store

ADDRESS_ENV_VARS = (contract.LWS_LEADER_ADDRESS, contract.JAX_COORDINATOR_ADDRESS)

# Pid of the pod's process, recorded so a restarted backend can re-adopt it.
PID_ANNOTATION_KEY = "local.lws.tpu/pid"


class _ReadoptedProcess:
    """Handle to a process spawned by a PREVIOUS backend incarnation: alive
    checks via signal 0; an exit while unowned reads as failure (we cannot
    reap its true status), which correctly trips the restart policy."""

    def __init__(self, pid: int) -> None:
        self.pid = pid

    def poll(self) -> Optional[int]:
        try:
            os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            return 1
        except PermissionError:
            return None

    def terminate(self) -> None:
        try:
            os.kill(self.pid, 15)
        except (ProcessLookupError, PermissionError):
            pass

    kill = terminate


def _pid_belongs_to_pod(pid: int, pod_name: str) -> bool:
    """Guard against pid reuse: the process env must carry our POD_NAME."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
        return f"POD_NAME={pod_name}".encode() in env
    except OSError:
        return False


class LocalBackend:
    name = "local-backend"

    def __init__(
        self,
        store: Store,
        env_overrides: Optional[dict[str, str]] = None,
        env_drop: tuple[str, ...] = (),
        default_command: Optional[list[str]] = None,
        log_dir: Optional[str] = None,
    ) -> None:
        self.store = store
        self.env_overrides = env_overrides or {}
        self.env_drop = env_drop
        self.default_command = default_command or ["sleep", "infinity"]
        self.log_dir = log_dir
        self._procs: dict[str, subprocess.Popen] = {}  # guarded-by: _lock — pod uid -> process
        self._lock = threading.Lock()

    def pod_logs(self, namespace: str, name: str) -> Optional[str]:
        """Captured stdout/stderr of the CURRENT pod incarnation (logs are
        keyed by uid so a recreated pod never shows its predecessor's output)."""
        if self.log_dir is None:
            return None
        pod = self.store.try_get("Pod", namespace, name)
        if pod is None:
            return None
        path = self._log_path(pod)
        if path is None or not os.path.exists(path):
            return None
        with open(path, errors="replace") as f:
            return f.read()

    def _log_path(self, pod: Pod) -> Optional[str]:
        if self.log_dir is None:
            return None
        return os.path.join(
            self.log_dir, f"{pod.meta.namespace}_{pod.meta.name}_{pod.meta.uid}.log"
        )

    # ------------------------------------------------------------------
    def reconcile(self, key: Key) -> Result | None:
        pod = self.store.try_get("Pod", key[1], key[2])
        if pod is None or not isinstance(pod, Pod):
            self._kill_orphans()
            return None
        with self._lock:
            proc = self._procs.get(pod.meta.uid)
        if proc is None:
            if pod.status.phase == PodPhase.PENDING:
                self._spawn(pod)
                return None
            if pod.status.phase == PodPhase.RUNNING:
                # Control-plane restart: re-adopt the live process (or report
                # it dead so the restart policy recreates the group).
                self._readopt(pod)
            return None
        code = proc.poll()
        if code is None:
            if pod.status.phase == PodPhase.PENDING:
                # Level-triggered repair: an earlier Running write lost its
                # optimistic-concurrency race; apply it now.
                self._mark_running(pod.meta.namespace, pod.meta.name, pod.meta.uid, proc.pid)
            return None
        # Process exited: report status (once).
        if code == 0 and pod.status.phase != PodPhase.SUCCEEDED:
            pod.status.phase = PodPhase.SUCCEEDED
            pod.status.ready = False
            self.store.update_status(pod)
        elif code != 0 and pod.status.phase != PodPhase.FAILED:
            pod.status.phase = PodPhase.FAILED
            pod.status.ready = False
            pod.status.container_restarts += 1
            pod.status.message = f"process exited with code {code}"
            self.store.update_status(pod)
        return None

    # ------------------------------------------------------------------
    def _spawn(self, pod: Pod) -> None:
        # A PENDING pod may still own a live pre-restart process (the snapshot
        # predated _mark_running's writes): adopt it instead of double-spawning
        # two workers onto the same chips/ports.
        raw_pid = pod.meta.annotations.get(PID_ANNOTATION_KEY)
        if raw_pid and raw_pid.isdigit():
            pid = int(raw_pid)
            if _pid_belongs_to_pod(pid, pod.meta.name):
                with self._lock:
                    self._procs[pod.meta.uid] = _ReadoptedProcess(pid)
                self._mark_running(pod.meta.namespace, pod.meta.name, pod.meta.uid, pid)
                return
        container = pod.spec.containers[0]
        command = container.command or self.default_command
        env = {k: v for k, v in os.environ.items() if k not in self.env_drop}
        for e in container.env:
            value = e.value.replace("$(POD_NAME)", pod.meta.name)  # downward-API-lite
            if e.name in ADDRESS_ENV_VARS:
                value = _localize(value)
            env[e.name] = value
        env["POD_NAME"] = pod.meta.name
        env["POD_NAMESPACE"] = pod.meta.namespace  # downward-API parity
        env.update(self.env_overrides)
        stdout = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(self._log_path(pod), "ab")  # noqa: SIM115 — owned by the child process
        try:
            proc = subprocess.Popen(command, env=env, stdout=stdout, stderr=stdout)
        except OSError as err:
            pod.status.phase = PodPhase.FAILED
            pod.status.message = f"spawn failed: {err}"
            self.store.update_status(pod)
            return
        with self._lock:
            self._procs[pod.meta.uid] = proc
        self._mark_running(pod.meta.namespace, pod.meta.name, pod.meta.uid, proc.pid)

    def _mark_running(self, namespace: str, name: str, uid: str, pid: int) -> None:
        """Record pid + Running status on the EXACT pod incarnation we spawned
        for; retries update races (further repair happens level-triggered in
        reconcile). A same-name/new-uid pod (group recreated mid-flight) must
        never inherit this process."""
        from lws_tpu_torch.core.store import ConflictError

        for _ in range(5):
            fresh = self.store.try_get("Pod", namespace, name)
            if fresh is None or fresh.meta.uid != uid:
                # Our pod incarnation is gone: the process is an orphan.
                with self._lock:
                    proc = self._procs.pop(uid, None)
                if proc is not None and proc.poll() is None:
                    proc.terminate()
                return
            try:
                fresh.meta.annotations[PID_ANNOTATION_KEY] = str(pid)
                fresh = self.store.update(fresh)
                fresh.status.phase = PodPhase.RUNNING
                fresh.status.ready = True
                fresh.status.address = "127.0.0.1"
                self.store.update_status(fresh)
                return
            except ConflictError:
                continue

    def _readopt(self, pod: Pod) -> None:
        raw_pid = pod.meta.annotations.get(PID_ANNOTATION_KEY)
        pid = int(raw_pid) if raw_pid and raw_pid.isdigit() else None
        if pid is not None and _pid_belongs_to_pod(pid, pod.meta.name):
            with self._lock:
                self._procs[pod.meta.uid] = _ReadoptedProcess(pid)
            return
        # Process gone or unverifiable: make sure it is not merely
        # unverifiable-but-alive (pid reuse aside, an unreadable /proc entry)
        # before the restart policy spawns a replacement next to it.
        if pid is not None:
            try:
                os.kill(pid, 15)
            except (ProcessLookupError, PermissionError):
                pass
        pod.status.phase = PodPhase.FAILED
        pod.status.ready = False
        pod.status.message = "process lost across control-plane restart"
        pod.status.container_restarts += 1
        self.store.update_status(pod)

    def _kill_orphans(self) -> None:
        """Kill processes whose pods no longer exist (group teardown)."""
        live_uids = {p.meta.uid for p in self.store.list("Pod")}  # vet: ignore[purity-fleet-scan]: the orphan sweep needs the COMPLETE live-uid set by definition; runs on the slow poll ticker
        with self._lock:
            dead = [uid for uid in self._procs if uid not in live_uids]
            for uid in dead:
                proc = self._procs.pop(uid)
                if proc.poll() is None:
                    proc.terminate()

    def poll_all(self) -> None:
        """Re-examine every tracked process (call from a ticker or tests)."""
        for pod in self.store.list("Pod"):
            self.reconcile(pod.key())
        self._kill_orphans()

    def shutdown(self) -> None:
        with self._lock:
            for proc in self._procs.values():
                if proc.poll() is None:
                    proc.terminate()
            self._procs.clear()


def _localize(value: str) -> str:
    """Rewrite `host[:port]` to `127.0.0.1[:port]`."""
    if ":" in value:
        _, port = value.rsplit(":", 1)
        if port.isdigit():
            return f"127.0.0.1:{port}"
    return "127.0.0.1"
