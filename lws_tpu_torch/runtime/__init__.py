"""Runtime: the assembled control plane, its cluster backends, and the
worker workloads a group's members run.

- harness.ControlPlane: store + admission + all controllers + scheduler wired
  into a Manager (≈ cmd/main.go setup, SURVEY §3.1).
- FakeKubelet: drives pod status like a node agent would (test/e2e backends).
- local.LocalBackend: runs pods as local processes; server.ApiServer: the
  control plane's HTTP face; fleet.FleetCollector: the workers' telemetry
  merged into /metrics/fleet; worker.py and telemetry.py: the group worker
  and its telemetry server.
"""

from lws_tpu_torch.runtime.harness import ControlPlane, FakeKubelet  # noqa: F401
