"""The port's command line: the control plane's commands and the `loadgen`
command of lws_tpu/cli.py, over the port's control plane and engines.

  python -m lws_tpu_torch serve  --config cfg.yaml [-f manifests.yaml ...] [--port N]
                                 [--state-file FILE | --state-dir DIR [--standby]
                                 [--no-fsync]] [--tls-dir DIR] [--token-file FILE]
  python -m lws_tpu_torch apply  -f manifests.yaml [--server HOST:PORT]
  python -m lws_tpu_torch get    KIND [NAME] [--server HOST:PORT] [-o yaml]
  python -m lws_tpu_torch delete KIND NAMESPACE NAME [--server HOST:PORT]
  python -m lws_tpu_torch scale  NAME REPLICAS [--server HOST:PORT]
  python -m lws_tpu_torch logs   POD [-n NAMESPACE] [--server HOST:PORT]
  python -m lws_tpu_torch events [NAME] [-n NAMESPACE] [--server HOST:PORT]
  python -m lws_tpu_torch cordon NODE [--uncordon] [--server HOST:PORT]
  python -m lws_tpu_torch drain  NODE [--server HOST:PORT]
  python -m lws_tpu_torch install DIR [--values FILE] [--set KEY=VALUE ...]
  python -m lws_tpu_torch plan-steps --initial 4,4 --target 4,4 [--surge 1,1] [--unavailable 0,0]
  python -m lws_tpu_torch top      [--server HOST:PORT] [--watch] [--by-class] [--by-tier]
  python -m lws_tpu_torch monitor  [FILTER] [--server HOST:PORT] [--watch]
  python -m lws_tpu_torch explain  [REQUEST_ID] [--slowest|--breached|--errored] [--json]
  python -m lws_tpu_torch rollout  [--server HOST:PORT] [--timeline-only] [--json]
  python -m lws_tpu_torch why      DECISION_ID|last[:scale|:rollout] [--json]
  python -m lws_tpu_torch profile  [--fleet] [--collapsed] [--server HOST:PORT]
  python -m lws_tpu_torch devices  [--server HOST:PORT] [--json]
  python -m lws_tpu_torch faults   [point=spec ...] [--clear] [--drain] [--server HOST:PORT]
  python -m lws_tpu_torch loadgen --list
  python -m lws_tpu_torch loadgen SCENARIO [--seed N] [--target dense|batch|paged]
                                  [--device cpu] [--server HOST:PORT] [--json]
  python -m lws_tpu_torch loadgen SCENARIO --prefill HOST:PORT --decode HOST:PORT

The flags, the output and the exit codes are the JAX package's
(`lws-tpu serve|apply|get|delete|scale|logs|events|cordon|drain|install|
plan-steps|top|monitor|explain|rollout|why|profile|devices|faults|loadgen`),
with the global `--cacert`, `--insecure`, `--token`, `--client-token-file`
and `$LWS_TPU_TOKEN` for an https or auth-enabled `--server`. `serve` runs
the control plane and its API server in a process that never touches the
card: the pods it runs (`backend: local`) are the processes that do.
`install` renders a bundle whose `start.sh`, systemd unit and Kubernetes
manifests run `python -m lws_tpu_torch serve`.

Two additions to `loadgen`: `--device` places the in-process target
(default: the card; with no card and no `--device cpu` the command raises
rather than run on the CPU), and an in-process target on the card writes
one line to stderr with its kernel launches (`engine_launch_line`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

_TLS_CONTEXT = None  # set by main() from --cacert/--insecure
_TOKEN = None  # set by main() from --token/--client-token-file/$LWS_TPU_TOKEN


def _url_context(url: str):
    return _TLS_CONTEXT if url.startswith("https://") else None


def _auth_headers() -> dict:
    return {"Authorization": f"Bearer {_TOKEN}"} if _TOKEN else {}


def _server_base(server: str) -> str:
    """Accept both `host:port` and a full `http://host:port` URL."""
    if server.startswith(("http://", "https://")):
        return server.rstrip("/")
    return f"http://{server}"


def _http(server: str, method: str, path: str, body: bytes | None = None):
    url = f"{_server_base(server)}{path}"
    req = urllib.request.Request(url, data=body, method=method, headers=_auth_headers())
    try:
        with urllib.request.urlopen(req, timeout=30, context=_url_context(url)) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        detail = e.read().decode()
        try:
            detail = json.loads(detail).get("error", detail)
        except (ValueError, AttributeError):
            pass
        raise SystemExit(f"error: {e.code}: {detail}") from None
    except urllib.error.URLError as e:
        raise SystemExit(f"error: cannot reach server {server}: {e.reason}") from None


def cmd_serve(args) -> int:
    from lws_tpu_torch.config import Configuration, load_configuration
    from lws_tpu_torch.core.serialize import load_store, save_store
    from lws_tpu_torch.manifest import load_manifests
    from lws_tpu_torch.runtime import ControlPlane
    from lws_tpu_torch.runtime.server import ApiServer

    cfg = load_configuration(args.config) if args.config else Configuration()
    if args.state_file and args.state_dir:
        raise SystemExit("error: --state-file and --state-dir are exclusive")
    cp = ControlPlane(
        scheduler_provider=cfg.gang_scheduling_management.scheduler_provider,
        enable_scheduler=cfg.enable_scheduler,
        auto_ready=(cfg.backend == "fake"),
    )
    from lws_tpu_torch.core.store import clone_info

    clone = clone_info()
    why = clone.get("library") or clone.get("reason") or f"the native build failed: {clone['error']}"
    print(f"store clone: {clone['clone']} ({why})", flush=True)
    state_dir = None
    if args.state_dir:
        from lws_tpu_torch.core.wal import StateDir, StateLockedError

        state_dir = StateDir(args.state_dir, fsync=not args.no_fsync)
        try:
            state_dir.acquire(wait=args.standby)
        except StateLockedError as e:
            raise SystemExit(
                f"error: {e}\nhint: add --standby to wait as a hot spare "
                "(takes over the instant the active process dies)"
            ) from None
        try:
            n = state_dir.attach(cp.store)
        except (ValueError, KeyError, TypeError) as e:
            raise SystemExit(
                f"error: state dir {args.state_dir} is corrupt ({e}); "
                "move it aside to start fresh"
            ) from None
        print(f"restored {n} objects from {args.state_dir} "
              "(WAL journaling on: every acknowledged write is durable)", flush=True)
        cp.resync()
    if args.state_file and os.path.exists(args.state_file):
        try:
            n = load_store(cp.store, args.state_file)
        except (ValueError, KeyError, TypeError) as e:
            # Refusing to start beats silently discarding cluster state.
            raise SystemExit(
                f"error: state file {args.state_file} is corrupt ({e}); "
                "move it aside to start fresh"
            ) from None
        print(f"restored {n} objects from {args.state_file}")
        cp.resync()
    if cfg.backend == "local":
        import tempfile
        import threading

        from lws_tpu_torch.runtime.local import LocalBackend

        log_dir = tempfile.mkdtemp(prefix="lws-tpu-logs-")
        backend = LocalBackend(cp.store, log_dir=log_dir)
        cp.manager.register(backend, {"Pod": lambda o: [o.key()]})
        cp.log_provider = backend.pod_logs
        print(f"pod logs under {log_dir}")

        def _poll_exits():
            # Process exits are not store events; poll them into pod status.
            while True:
                time.sleep(2.0)
                try:
                    backend.poll_all()
                except Exception:  # noqa: BLE001 — the exit-poll loop must outlive one bad poll
                    pass

        threading.Thread(target=_poll_exits, daemon=True).start()

    for path in args.filename or []:
        for obj in load_manifests(path):
            # Apply semantics: a restart with the same -f manifests over a
            # restored state file must not crash on already-existing objects.
            if cp.store.try_get(obj.kind, obj.meta.namespace, obj.meta.name) is None:
                cp.store.create(obj)
                print(f"created {obj.kind}/{obj.meta.name}")
            else:
                print(f"exists {obj.kind}/{obj.meta.name} (restored)")

    tls = None
    if args.tls_dir:
        from lws_tpu_torch.core.certs import CertManager

        tls = CertManager(args.tls_dir)
        paths = tls.ensure()
        print(f"serving TLS; clients trust {paths.ca_cert}")
    auth = None
    if args.token_file:
        from lws_tpu_torch.core.auth import TokenAuth

        auth = TokenAuth.load(args.token_file)
        print(f"API authentication on ({len(auth.entries)} token(s) from "
              f"{args.token_file}; /healthz and /readyz stay open)")
    from lws_tpu_torch.core import profile as profmod

    if profmod.start_from_env() is not None:
        print(f"continuous profiler on at {profmod.PROFILER.hz:g} Hz "
              "(GET /debug/profile)")
    server = ApiServer(cp, port=args.port, tls=tls, auth=auth)
    dirty = {"flag": True}  # always persist once after boot
    if args.state_file:
        # Register BEFORE the manager threads start: the first burst of
        # post-restore reconcile writes must mark the state dirty too.
        cp.store.watch(lambda _ev: dirty.__setitem__("flag", True))
    server.start()
    cp.start()
    from lws_tpu_torch.version import user_agent

    scheme = "https" if tls else "http"
    print(f"{user_agent()} serving on {scheme}://127.0.0.1:{server.port} "
          f"(backend={cfg.backend}, scheduler={cfg.enable_scheduler})", flush=True)
    try:
        while True:
            time.sleep(5 if args.state_file else 3600)
            if args.state_file and dirty["flag"]:
                dirty["flag"] = False
                save_store(cp.store, args.state_file)
    except KeyboardInterrupt:
        cp.stop()
        server.stop()
        if args.state_file:
            save_store(cp.store, args.state_file)
        if state_dir is not None:
            state_dir.close()  # final compaction + lock release → instant failover
    return 0


def cmd_apply(args) -> int:
    with open(args.filename) as f:
        body = f.read().encode()
    out = _http(args.server, "POST", "/apply", body)
    print(json.dumps(out))
    return 0


def cmd_get(args) -> int:
    if args.name:
        out = _http(args.server, "GET", f"/apis/{args.kind}/{args.namespace}/{args.name}")
        if args.output == "yaml":
            import yaml

            print(yaml.safe_dump(out, sort_keys=False))
        else:
            print(json.dumps(out, indent=1))
        return 0
    objs = _http(args.server, "GET", f"/apis/{args.kind}")
    for o in objs:
        status = o.get("status") or {}
        if "ready_replicas" in status:
            detail = f"ready={status['ready_replicas']}"
        elif "phase" in status:
            detail = f"phase={status['phase']}\tready={status.get('ready')}"
        else:
            detail = ""
        print(f"{o['metadata']['namespace']}/{o['metadata']['name']}\t{detail}")
    return 0


def cmd_delete(args) -> int:
    print(json.dumps(_http(args.server, "DELETE", f"/apis/{args.kind}/{args.namespace}/{args.name}")))
    return 0


def cmd_logs(args) -> int:
    url = f"{_server_base(args.server)}/logs/{args.namespace}/{args.name}"
    req = urllib.request.Request(url, headers=_auth_headers())
    try:
        with urllib.request.urlopen(req, timeout=30, context=_url_context(url)) as resp:
            sys.stdout.write(resp.read().decode(errors="replace"))
        return 0
    except urllib.error.HTTPError as e:
        print(f"error: {e.code}: {e.read().decode()}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        raise SystemExit(f"error: cannot reach server {args.server}: {e.reason}") from None


def cmd_events(args) -> int:
    from urllib.parse import urlencode

    q = {k: v for k, v in (("namespace", args.namespace), ("name", args.name)) if v}
    path = "/events" + (f"?{urlencode(q)}" if q else "")
    now = time.time()
    for ev in _http(args.server, "GET", path):
        age = max(0, int(now - ev["timestamp"]))
        print(f"{age}s\t{ev['type']}\t{ev['reason']}\t{ev['object']}\t{ev['message']}")
    return 0


def cmd_cordon(args) -> int:
    body = json.dumps({"unschedulable": not args.uncordon}).encode()
    print(json.dumps(_http(args.server, "POST", f"/cordon/{args.node}", body)))
    return 0


def cmd_drain(args) -> int:
    print(json.dumps(_http(args.server, "POST", f"/drain/{args.node}", b"{}")))
    return 0


# Parameterized install values (≈ ref charts/lws/values.yaml): every knob
# the rendered bundle honors, with its default. Strict: unknown keys are
# rejected, values are coerced to the default's type.
INSTALL_VALUES = {
    "port": 9443,
    "backend": "local",            # pod backend: local | fake
    "enableScheduler": True,
    "schedulerProvider": "gang",   # "" | gang | external[:name]
    "namespace": "lws-tpu-system",  # k8s hosted-mode namespace
    "replicaCount": 2,             # hosted-mode replicas (active + standby)
    "image": "lws-tpu:latest",     # hosted-mode controller image
    "serviceType": "ClusterIP",
    "enablePrometheus": False,     # scrape annotations on the hosted pod
    "nameOverride": "",            # k8s object name prefix override
}


def resolve_install_values(values_file, sets, port=None, backend=None) -> dict:
    """defaults <- --values file <- --set k=v (helm precedence); --port and
    --backend remain as aliases for their values keys."""
    values = dict(INSTALL_VALUES)

    def apply(key, raw):
        if key not in values:
            raise ValueError(
                f"unknown install value {key!r} (known: {', '.join(sorted(values))})"
            )
        default = INSTALL_VALUES[key]
        if isinstance(default, bool):
            if isinstance(raw, bool):
                values[key] = raw
            elif str(raw).lower() in ("true", "1", "yes"):
                values[key] = True
            elif str(raw).lower() in ("false", "0", "no"):
                values[key] = False
            else:
                raise ValueError(f"{key} must be a boolean, got {raw!r}")
        elif isinstance(default, int):
            try:
                values[key] = int(raw)
            except (TypeError, ValueError):
                raise ValueError(f"{key} must be an integer, got {raw!r}") from None
        else:
            values[key] = str(raw)

    if values_file:
        import yaml

        with open(values_file) as f:
            try:
                data = yaml.safe_load(f) or {}
            except yaml.YAMLError as e:
                raise ValueError(f"{values_file}: invalid YAML ({e})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{values_file} must contain a mapping")
        for k, v in data.items():
            apply(k, v)
    for item in sets or ():
        if "=" not in item:
            raise ValueError(f"--set expects key=value, got {item!r}")
        k, v = item.split("=", 1)
        apply(k.strip(), v.strip())
    if port is not None:
        values["port"] = port
    if backend is not None:
        values["backend"] = backend
    if values["backend"] not in ("local", "fake"):
        raise ValueError(f"backend must be 'local' or 'fake', got {values['backend']!r}")
    if values["serviceType"] not in ("ClusterIP", "NodePort", "LoadBalancer"):
        raise ValueError(f"invalid serviceType {values['serviceType']!r}")
    return values


def cmd_install(args) -> int:
    """Render a one-command deployable bundle (≈ ref charts/lws + config/
    kustomize install tree + config/rbac): component config, TLS material,
    API tokens, durable state dir, a systemd unit, and optional Kubernetes
    manifests for clusters that host the control plane as a pod. Values-
    parameterized like the reference helm chart: --values file.yaml and
    repeatable --set key=value override INSTALL_VALUES."""
    import os
    import stat

    from lws_tpu_torch.core.auth import write_bootstrap_tokens
    from lws_tpu_torch.core.certs import CertManager

    try:
        values = resolve_install_values(args.values, args.set, args.port, args.backend)
    except (ValueError, OSError) as e:
        print(f"install: {e}", file=sys.stderr)
        return 1
    port = values["port"]
    namespace = values["namespace"]
    app_name = values["nameOverride"] or "lws-tpu"

    root = os.path.abspath(args.dir)
    os.makedirs(root, exist_ok=True)
    state_dir = os.path.join(root, "state")
    os.makedirs(state_dir, exist_ok=True)

    token_path = os.path.join(root, "tokens.csv")
    if os.path.exists(token_path):
        # Re-rendering the bundle must NOT rotate credentials already handed
        # to clients; delete tokens.csv explicitly to rotate.
        from lws_tpu_torch.core.auth import TokenAuth

        tokens = {e.role: e.token for e in TokenAuth.load(token_path).entries}
        print(f"preserved existing tokens at {token_path}")
    else:
        tokens = write_bootstrap_tokens(token_path)
    paths = CertManager(os.path.join(root, "tls")).ensure()

    gang_section = (
        f"gangSchedulingManagement:\n  schedulerProvider: {values['schedulerProvider']}\n"
        if values["schedulerProvider"]
        else ""
    )
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write(
            "# lws-tpu component config (strict-decoded; see lws_tpu_torch/config.py)\n"
            f"api:\n  port: {port}\n"
            f"backend: {values['backend']}\n"
            f"enableScheduler: {'true' if values['enableScheduler'] else 'false'}\n"
            + gang_section
        )

    serve_cmd = (
        f"{args.python} -m lws_tpu_torch serve --config {root}/config.yaml "
        f"--port {port} --state-dir {state_dir} "
        f"--tls-dir {root}/tls --token-file {root}/tokens.csv"
    )
    start = os.path.join(root, "start.sh")
    with open(start, "w") as f:
        f.write(f"#!/bin/sh\n# active control plane (add --standby on a hot spare)\nexec {serve_cmd} \"$@\"\n")
    os.chmod(start, os.stat(start).st_mode | stat.S_IEXEC)

    with open(os.path.join(root, "lws-tpu.service"), "w") as f:
        f.write(
            "[Unit]\n"
            "Description=lws-tpu control plane\n"
            "After=network-online.target\n\n"
            "[Service]\n"
            f"ExecStart={serve_cmd}\n"
            "Restart=always\nRestartSec=2\n\n"
            "[Install]\nWantedBy=multi-user.target\n"
        )

    k8s = os.path.join(root, "kubernetes")
    os.makedirs(k8s, exist_ok=True)
    prom_annotations = (
        "      annotations:\n"
        "        prometheus.io/scrape: 'true'\n"
        f"        prometheus.io/port: '{port}'\n"
        if values["enablePrometheus"]
        else ""
    )
    with open(os.path.join(k8s, "deployment.yaml"), "w") as f:
        f.write(
            "# Hosted mode: run the control plane as a cluster workload\n"
            "# (tokens/TLS mounted from the Secret; state on a PVC so the WAL\n"
            "#  survives rescheduling). kubectl apply -f kubernetes/\n"
            "apiVersion: apps/v1\nkind: Deployment\nmetadata:\n"
            f"  name: {app_name}-controller\n  namespace: {namespace}\n"
            f"spec:\n  replicas: {values['replicaCount']}"
            "  # active + --standby hot spares over the shared PVC\n"
            f"  selector:\n    matchLabels: {{app: {app_name}}}\n"
            f"  template:\n    metadata:\n      labels: {{app: {app_name}}}\n"
            + prom_annotations +
            "    spec:\n      containers:\n      - name: controller\n"
            f"        image: {values['image']}\n"
            "        command: [python, -m, lws_tpu_torch]\n"
            f"        args: [serve, --config, /etc/lws-tpu/config.yaml, --port, '{port}',\n"
            "               --state-dir, /var/lib/lws-tpu, --tls-dir, /etc/lws-tpu/tls,\n"
            "               --token-file, /etc/lws-tpu/tokens.csv, --standby]\n"
            f"        ports: [{{containerPort: {port}}}]\n"
            "        readinessProbe: {httpGet: {path: /readyz, port: "
            f"{port}, scheme: HTTPS}}}}\n"
            "        volumeMounts:\n"
            "        - {name: config, mountPath: /etc/lws-tpu}\n"
            "        - {name: state, mountPath: /var/lib/lws-tpu}\n"
            "      volumes:\n"
            f"      - {{name: config, secret: {{secretName: {app_name}-config}}}}\n"
            f"      - {{name: state, persistentVolumeClaim: {{claimName: {app_name}-state}}}}\n"
            "---\n"
            "apiVersion: v1\nkind: Service\nmetadata:\n"
            f"  name: {app_name}\n  namespace: {namespace}\n"
            f"spec:\n  type: {values['serviceType']}\n"
            f"  selector: {{app: {app_name}}}\n"
            f"  ports: [{{port: {port}, targetPort: {port}}}]\n"
        )
    with open(os.path.join(k8s, "README.md"), "w") as f:
        f.write(
            "Create the config Secret + state PVC, then apply:\n\n"
            f"    kubectl create namespace {namespace}\n"
            f"    kubectl -n {namespace} create secret generic {app_name}-config \\\n"
            "        --from-file=config.yaml=../config.yaml "
            "--from-file=tokens.csv=../tokens.csv\n"
            f"    kubectl -n {namespace} apply -f .\n"
        )
    # The resolved values, recorded for reproducible re-renders (helm's
    # `helm get values` analog).
    import yaml as _yaml

    with open(os.path.join(root, "values.yaml"), "w") as f:
        _yaml.safe_dump(values, f, default_flow_style=False)

    with open(os.path.join(root, "README.md"), "w") as f:
        f.write(
            "# lws-tpu install bundle\n\n"
            "Start the control plane (TLS + token auth + durable WAL state):\n\n"
            f"    {start}\n\n"
            "Hot-spare HA on the same host/filesystem:\n\n"
            f"    {start} --standby\n\n"
            "Client usage:\n\n"
            f"    export LWS_TPU_TOKEN=$(head -2 {root}/tokens.csv | tail -1 | cut -d, -f1)\n"
            f"    {args.python} -m lws_tpu_torch --cacert {paths.ca_cert} get lws "
            f"--server https://127.0.0.1:{port}\n\n"
            "Files: config.yaml (component config), tokens.csv (admin+view\n"
            "Bearer tokens, 0600), tls/ (auto-rotated self-signed CA+cert),\n"
            "state/ (snapshot + write-ahead log), lws-tpu.service (systemd),\n"
            "kubernetes/ (hosted-mode manifests).\n"
        )

    print(f"bundle rendered at {root}")
    print(f"  start:       {start}")
    admin = tokens.get("admin")
    if admin:
        print(f"  admin token: {admin[:8]}… (full value in tokens.csv)")
    else:  # preserved file the operator customized; don't crash post-render
        print("  tokens:      preserved tokens.csv has no admin-role entry")
    print(f"  ca cert:     {paths.ca_cert}")
    return 0


def cmd_scale(args) -> int:
    body = json.dumps({"replicas": args.replicas}).encode()
    print(json.dumps(_http(args.server, "POST", f"/scale/{args.namespace}/{args.name}", body)))
    return 0


# ---------------------------------------------------------------------------
# lws-tpu top: the operator's live fleet view, rendered from the aggregated
# /metrics/fleet surface + the /debug/flightrecorder alert state.


def _histogram_quantile(buckets: list[tuple[float, float]], q: float):
    """Estimate a quantile from cumulative (le, count) pairs — the PromQL
    histogram_quantile shape (the implementation lives with the other
    derived-signal math in lws_tpu_torch/obs/signals.py)."""
    from lws_tpu_torch.obs.signals import histogram_quantile

    return histogram_quantile(buckets, q)


def _top_rows(fams: dict, by_class: bool = False) -> dict:
    """Fold parsed fleet families into {(instance, engine): row} — or, with
    `by_class`, {(instance, engine, klass): row}, splitting every
    class-labelled series into its own row (class-free series keep a `-`
    class). Pure function of the exposition so tests drive it from canned
    text."""
    rows: dict = {}

    def row(labels):
        key = (labels.get("instance", "-"), labels.get("engine", "-"))
        if by_class:
            key += (labels.get("klass", "-") or "-",)
        return rows.setdefault(key, {})

    def fold(family, field, reducer=lambda old, v: old + v, start=0.0):
        for name, labels, value, _ in fams.get(family, {}).get("samples", []):
            # Histograms fold their _count sample; plain metrics their name.
            if name != family and name != f"{family}_count":
                continue
            r = row(labels)
            r[field] = reducer(r.get(field, start), value)

    fold("serving_requests_total", "requests")
    # KV-transfer wire bytes (streamed + monolithic handoffs). The metric
    # carries no engine label, so it folds into the instance's `-` row;
    # render_top rates it per instance as the KV MB/s column.
    fold("serving_kv_transfer_bytes_total", "kv_bytes")
    fold("serving_active_slots", "active")
    fold("serving_inflight_dispatches", "inflight")
    fold("serving_slo_attainment", "slo", reducer=lambda old, v: v)
    fold("serving_decode_dispatch_duration_seconds", "dispatches")
    # Prefix hits carry a tier label (hbm/host/remote) since the spill tier
    # landed; fold the aggregate AND per-tier fields so render_top can show
    # either the single PFX% column or the --by-tier breakdown. Legacy
    # tier-less series (older workers mid-rollout) count as hbm.
    for name, labels, value, _ in fams.get(
            "serving_prefix_cache_hits_total", {}).get("samples", []):
        if name != "serving_prefix_cache_hits_total":
            continue
        r = row(labels)
        r["pfx_hits"] = r.get("pfx_hits", 0.0) + value
        tier = labels.get("tier", "hbm") or "hbm"
        field = f"pfx_hits_{tier}"
        r[field] = r.get(field, 0.0) + value
    fold("serving_prefix_cache_misses_total", "pfx_misses")
    # Goodput ledger (core/slo.py): delivered vs delivered-on-time tokens.
    # Without --by-class the per-class series of one engine sum into its
    # row, so GOODPUT% is the engine's overall on-time fraction.
    fold("serving_tokens_total", "tokens")
    fold("serving_goodput_tokens_total", "good_tokens")

    # KV-pool occupancy: the state-labelled block gauge folds into per-row
    # kv_free/kv_live/kv_parked; render_top derives live/(free+live+parked).
    for name, labels, value, _ in fams.get("serving_kv_pool_blocks", {}).get("samples", []):
        if name != "serving_kv_pool_blocks":
            continue
        r = row(labels)
        field = f"kv_{labels.get('state', '?')}"
        r[field] = r.get(field, 0.0) + value

    # Speculation: the kind-labelled token counter folds into per-row
    # spec_drafted/spec_accepted; render_top derives the accept rate
    # (SPEC%) — the knob-tuning signal for gamma/ngram.
    for name, labels, value, _ in fams.get("serving_spec_tokens_total", {}).get("samples", []):
        if name != "serving_spec_tokens_total":
            continue
        r = row(labels)
        field = f"spec_{labels.get('kind', '?')}"
        r[field] = r.get(field, 0.0) + value

    # HBM occupancy: the device-labelled gauges are engine-less, so they
    # fold (summed across an instance's devices) into the instance's `-`
    # row; render_top derives in_use/limit as the HBM% column.
    fold("serving_hbm_bytes_in_use", "hbm_in_use")
    fold("serving_hbm_bytes_limit", "hbm_limit")
    # Compile ledger: the kind-labelled counter folds into per-row
    # cmp_first/cmp_recompile. render_top's CMP cell prefers the WINDOWED
    # recompile count from history_rates (steady nonzero = storm in
    # progress) and falls back to the lifetime recompile total.
    for name, labels, value, _ in fams.get("serving_compiles_total", {}).get("samples", []):
        if name != "serving_compiles_total":
            continue
        r = row(labels)
        field = f"cmp_{labels.get('kind', '?')}"
        r[field] = r.get(field, 0.0) + value

    for family, field in (("serving_ttft_seconds", "ttft"),
                          ("serving_itl_seconds", "itl")):
        per_key: dict = {}
        for name, labels, value, _ in fams.get(family, {}).get("samples", []):
            if not name.endswith("_bucket"):
                continue
            le = labels.get("le", "+Inf")
            le_f = float("inf") if le == "+Inf" else float(le)
            key = (labels.get("instance", "-"), labels.get("engine", "-"))
            if by_class:
                key += (labels.get("klass", "-") or "-",)
            per_key.setdefault(key, []).append((le_f, value))
        for key, buckets in per_key.items():
            r = rows.setdefault(key, {})
            r[f"{field}_p95"] = _histogram_quantile(buckets, 0.95)
    return rows


def history_rates(ring, now: float | None = None, window_s: float = 30.0,
                  by_class: bool = False) -> dict:
    """Fold a HistoryRing into the per-row rate cells `render_top` renders:
    {row key: {disp_rate, kv_mbps, good}}. Rates come from the ring's
    retained points (`obs/signals.rate` over the trailing `window_s`), so
    the FIRST rendered frame already has them when the ring was seeded from
    the server's /debug/history — and a skipped scrape widens a rate's
    denominator instead of corrupting it. GOOD% here is the WINDOW's
    on-time fraction (increase(good)/increase(total)), not the lifetime
    ratio — a recovering engine's column recovers with it."""
    from lws_tpu_torch.obs import signals

    def key_of(labels: dict) -> tuple:
        key = (labels.get("instance", "-"), labels.get("engine", "-"))
        if by_class:
            key += (labels.get("klass", "-") or "-",)
        return key

    rates: dict = {}

    def slot(key: tuple) -> dict:
        return rates.setdefault(key, {})

    for _, labels, _, pts, _ in ring.series(
            "serving_decode_dispatch_duration_seconds_count"):
        r = signals.rate(pts, window_s, now)
        if r is not None:
            s = slot(key_of(labels))
            s["disp_rate"] = s.get("disp_rate", 0.0) + r
    # The KV transfer counter is engine-less (it lives in the transport):
    # it folds into the instance's `-` row, exactly like _top_rows.
    for _, labels, _, pts, _ in ring.series("serving_kv_transfer_bytes_total"):
        r = signals.rate(pts, window_s, now)
        if r is not None:
            key = (labels.get("instance", "-"), "-")
            if by_class:
                key += ("-",)
            s = slot(key)
            s["kv_mbps"] = s.get("kv_mbps", 0.0) + r / 1e6
    # Recompiles in the window (the CMP column): increase() over the
    # kind=recompile compile counter — one steady-state recompile per
    # window per executable is exactly the bucket-miss signature
    # docs/tasks/device-observability.md walks through.
    for _, labels, _, pts, _ in ring.series("serving_compiles_total"):
        if (labels.get("kind") or "") != "recompile":
            continue
        inc = signals.increase(pts, window_s, now)
        if inc is not None:
            s = slot(key_of(labels))
            s["cmp"] = s.get("cmp", 0.0) + inc
    inc_good: dict = {}
    inc_tok: dict = {}
    for family, acc in (("serving_goodput_tokens_total", inc_good),
                        ("serving_tokens_total", inc_tok)):
        for _, labels, _, pts, _ in ring.series(family):
            inc = signals.increase(pts, window_s, now)
            if inc is not None:
                key = key_of(labels)
                acc[key] = acc.get(key, 0.0) + inc
    for key, tok in inc_tok.items():
        if tok > 0:
            slot(key)["good"] = inc_good.get(key, 0.0) / tok
    return rates


def render_top(fams: dict, alerts: dict | None = None,
               prev: dict | None = None, dt_s: float | None = None,
               rows: dict | None = None, by_class: bool = False,
               rates: dict | None = None, top_k: int = 40,
               by_tier: bool = False) -> str:
    """One frame of `lws-tpu top`. `rates` (a `history_rates` fold over the
    HistoryRing) supplies the DISP/S, KV_MB/S, and windowed GOOD% cells —
    present from the very first frame when the ring was seeded from
    /debug/history. `prev`/`dt_s` (a previous _top_rows fold and the
    seconds since it) remain the frame-to-frame fallback for servers
    without the history surface; one-shot renders totals. `rows` takes a
    precomputed _top_rows fold so --watch folds each frame once, not
    twice. With `by_class` (`--by-class`), class-labelled series split
    into one row per (instance, engine, klass) — `rows`/`prev`/`rates`
    must then be by-class folds too. `top_k` bounds the table to the
    worst rows (lowest SLO attainment first; rows without an attainment
    gauge sort after the judged ones) with a truncation footer — at 1,000
    instances an unbounded frame is a scroll buffer, not a view. 0 means
    unbounded."""
    if rows is None:
        rows = _top_rows(fams, by_class=by_class)
    instances = None
    for name, _labels, value, _ in fams.get("lws_fleet_instances", {}).get("samples", []):
        if name == "lws_fleet_instances":
            instances = int(value)
    lines = []
    header = f"FLEET  instances={instances if instances is not None else len({k[0] for k in rows})}"
    firing = sorted((alerts or {}).keys())
    header += f"  alerts={','.join(firing) if firing else 'none'}"
    lines.append(header)
    for name, details in sorted((alerts or {}).items()):
        for d in details:
            lines.append(f"  ALERT {name}: {json.dumps(d)}")
    klass_col = f"{'CLASS':<9}" if by_class else ""
    # --by-tier splits PFX% into the hierarchy's shares of all lookups
    # (h=hbm resident, H=host arena restore, R=remote sibling fetch), so
    # h+H+R = PFX% and the gap to 100% is the miss (recompute) share.
    tier_cols = f"{'h%':>5}{'H%':>5}{'R%':>5}" if by_tier else ""
    lines.append(
        f"{'INSTANCE':<18}{'ENGINE':<9}{klass_col}{'SLO':>6}{'REQS':>7}{'ACTIVE':>7}"
        f"{'INFL':>6}{'KV%':>6}{'HBM%':>6}{'PFX%':>6}{tier_cols}{'SPEC%':>7}{'GOOD%':>7}{'TTFT_P95':>10}"
        f"{'ITL_P95':>10}{'DISP/S':>8}{'KV_MB/S':>9}{'CMP':>5}"
    )

    def fmt(v, pattern="{:.3f}", dash="-"):
        return pattern.format(v) if v is not None else dash

    blank_key = (lambda i: (i, "-", "-")) if by_class else (lambda i: (i, "-"))
    table = [
        (key, r) for key, r in sorted(rows.items())
        if not (key[1] == "-" and "requests" not in r and "slo" not in r)
    ]  # drop fleet-plumbing rows without serving data
    # Worst first: burning/missing-attainment rows must survive the bound.
    table.sort(key=lambda kr: (kr[1].get("slo") is None,
                               kr[1].get("slo") or 0.0, kr[0]))
    hidden_instances: set = set()
    hidden_rows = 0
    if top_k and len(table) > top_k:
        hidden_rows = len(table) - top_k
        shown_instances = {key[0] for key, _ in table[:top_k]}
        hidden_instances = {
            key[0] for key, _ in table[top_k:]
        } - shown_instances
        table = table[:top_k]
    for key, r in table:
        if by_class:
            instance, engine, klass = key
        else:
            instance, engine = key
            klass = None
        rr = (rates or {}).get(key, {})
        rate = rr.get("disp_rate")
        if rate is None and prev is not None and dt_s:
            before = prev.get(key, {}).get("dispatches", 0.0)
            rate = max(0.0, r.get("dispatches", 0.0) - before) / dt_s
        # KV handoff wire throughput: the transfer counter is engine-less
        # (it lives in the transport), so it rides the instance's `-` row.
        kv_rate = rr.get("kv_mbps")
        if kv_rate is None and rates is not None:
            kv_rate = rates.get(blank_key(instance), {}).get("kv_mbps")
        if kv_rate is None:
            kv_now = r.get("kv_bytes", rows.get(blank_key(instance), {}).get("kv_bytes"))
            if prev is not None and dt_s and kv_now is not None:
                kv_prev = prev.get(key, {}).get(
                    "kv_bytes", prev.get(blank_key(instance), {}).get("kv_bytes", 0.0))
                kv_rate = max(0.0, kv_now - kv_prev) / dt_s / 1e6
        # KV-pool occupancy (live / pool) and prefix-cache hit rate — the
        # capacity columns: a row pinned near 100% KV with a low hit rate
        # is the backpressure case paging exists to relieve.
        kv = None
        pool = r.get("kv_free", 0.0) + r.get("kv_live", 0.0) + r.get("kv_parked", 0.0)
        if pool > 0:
            kv = r.get("kv_live", 0.0) / pool
        # HBM occupancy: the device gauges are engine-less, so they ride
        # the instance's `-` row (same routing as KV_MB/S).
        hbm = None
        hbm_row = r if r.get("hbm_limit") else rows.get(blank_key(instance), {})
        if hbm_row.get("hbm_limit", 0.0) > 0:
            hbm = hbm_row.get("hbm_in_use", 0.0) / hbm_row["hbm_limit"]
        # CMP: recompiles in the rate window (ring-fed) — lifetime total
        # as the one-shot fallback. A row that keeps a nonzero CMP is
        # paying XLA compile time on steady-state traffic.
        cmp_n = rr.get("cmp")
        if cmp_n is None and ("cmp_recompile" in r or "cmp_first" in r):
            cmp_n = r.get("cmp_recompile", 0.0)
        pfx = None
        tier_share = {"hbm": None, "host": None, "remote": None}
        lookups = r.get("pfx_hits", 0.0) + r.get("pfx_misses", 0.0)
        if lookups > 0:
            pfx = r.get("pfx_hits", 0.0) / lookups
            for tier in tier_share:
                tier_share[tier] = r.get(f"pfx_hits_{tier}", 0.0) / lookups
        # Speculation accept rate: accepted/drafted draft tokens. Low SPEC%
        # with speculation on means gamma is burning verify width for
        # nothing on this traffic (docs/tasks/speculative-decoding.md).
        spec = None
        if r.get("spec_drafted", 0.0) > 0:
            spec = r.get("spec_accepted", 0.0) / r["spec_drafted"]
        # Goodput fraction: tokens delivered within their deadline / tokens
        # delivered (core/slo.py ledger). A row serving fast-but-late work
        # shows high DISP/S with a sagging GOOD% — throughput that isn't
        # helping anyone.
        good = rr.get("good")
        if good is None and r.get("tokens", 0.0) > 0:
            good = r.get("good_tokens", 0.0) / r["tokens"]
        klass_cell = f"{klass:<9}" if by_class else ""
        tier_cells = "" if not by_tier else (
            f"{fmt(tier_share['hbm'], '{:.0%}'):>5}"
            f"{fmt(tier_share['host'], '{:.0%}'):>5}"
            f"{fmt(tier_share['remote'], '{:.0%}'):>5}"
        )
        lines.append(
            f"{instance:<18}{engine:<9}{klass_cell}"
            f"{fmt(r.get('slo'), '{:.2f}'):>6}"
            f"{fmt(r.get('requests'), '{:.0f}'):>7}"
            f"{fmt(r.get('active'), '{:.0f}'):>7}"
            f"{fmt(r.get('inflight'), '{:.0f}'):>6}"
            f"{fmt(kv, '{:.0%}'):>6}"
            f"{fmt(hbm, '{:.0%}'):>6}"
            f"{fmt(pfx, '{:.0%}'):>6}{tier_cells}"
            f"{fmt(spec, '{:.0%}'):>7}"
            f"{fmt(good, '{:.0%}'):>7}"
            f"{fmt(r.get('ttft_p95'), '{:.3f}s'):>10}"
            f"{fmt(r.get('itl_p95'), '{:.4f}s'):>10}"
            f"{fmt(rate, '{:.1f}'):>8}"
            f"{fmt(kv_rate, '{:.1f}'):>9}"
            f"{fmt(cmp_n, '{:.0f}'):>5}"
        )
    if hidden_rows:
        what = (f"{len(hidden_instances)} more instances"
                if hidden_instances else f"{hidden_rows} more rows")
        lines.append(f"… {what} (raise --top-k)")
    return "\n".join(lines)


def _fetch_top_state(server: str) -> tuple[dict, dict, str]:
    """(parsed fleet families, active alerts, raw exposition text) from the
    API server — the raw text also feeds the client-side HistoryRing.
    Alerts merge two feeds: the control plane's own watchdog (live detail
    via /debug/flightrecorder) and any WORKER whose `lws_watchdog_active`
    gauge rides the fleet scrape at 1 — a worker-side stall renders here
    too."""
    from lws_tpu_torch.core.metrics import parse_exposition

    url = f"{_server_base(server)}/metrics/fleet"
    req = urllib.request.Request(url, headers=_auth_headers())
    with urllib.request.urlopen(req, timeout=30, context=_url_context(url)) as resp:
        text = resp.read().decode()
    fams = parse_exposition(text)
    alerts = {}
    for name, labels, value, _ in fams.get("lws_watchdog_active", {}).get("samples", []):
        if name == "lws_watchdog_active" and value >= 1.0:
            alerts.setdefault(labels.get("watchdog", "?"), []).append(
                {"instance": labels.get("instance", "-")}
            )
    try:
        fr = _http(server, "GET", "/debug/flightrecorder?limit=0")
        for name, details in (fr.get("alerts") or {}).items():
            alerts[name] = details  # richer detail wins over the gauge row
    except SystemExit:
        pass  # an older server without the endpoint still gets the table
    return fams, alerts, text


def cmd_top(args) -> int:
    """Live fleet view: SLO attainment, throughput/occupancy, in-flight
    depth, and watchdog alerts from the aggregated /metrics/fleet surface.
    One-shot by default; --watch redraws every --interval seconds (floored
    at 1s — the fleet collector caches scrapes for ~1s). Rate columns
    (DISP/S, KV_MB/S) and the windowed GOOD% derive from a client-side
    HistoryRing seeded from the server's /debug/history, so the FIRST
    frame already renders them and a skipped scrape widens a rate's
    window instead of corrupting it."""
    from lws_tpu_torch.obs.history import HistoryRing

    args.interval = max(args.interval, 1.0)
    ring = HistoryRing(interval_s=0.0, retention_s=600.0)
    prev = prev_t = None
    first = True
    seeded = False
    while True:
        try:
            fams, alerts, text = _fetch_top_state(args.server)
        except urllib.error.URLError as e:
            raise SystemExit(
                f"error: cannot reach server {args.server}: {e.reason}"
            ) from None
        now = time.monotonic()
        if first:
            first = False
            try:
                # The server's retained history gives frame 1 real rates;
                # an older server without the endpoint degrades to the
                # frame-to-frame fallback.
                seeded = ring.load_snapshot(
                    _http(args.server, "GET", "/debug/history?limit=4096"),
                    now=now,
                ) > 0
            except SystemExit:
                pass
            if seeded:
                # Frame 1 renders from the seed ALONE: the fleet text just
                # fetched may be older than the server ring's newest ingest
                # (collector cache), and ingesting it would misread the
                # older raw counters as a reset. Frame 2+ fetches are fresh
                # renders (the cache expires within the watch interval).
                text = None
        if text is not None:
            ring.ingest(text, now=now)
        by_class = getattr(args, "by_class", False)
        rows = _top_rows(fams, by_class=by_class)
        rates = history_rates(
            ring, now=now, window_s=max(30.0, 3 * args.interval),
            by_class=by_class,
        )
        frame = render_top(
            fams, alerts, prev=prev,
            dt_s=(now - prev_t) if prev_t is not None else None,
            rows=rows, by_class=by_class, rates=rates,
            top_k=getattr(args, "top_k", 40),
            by_tier=getattr(args, "by_tier", False),
        )
        if not args.watch:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        prev, prev_t = rows, now
        time.sleep(args.interval)


# ---------------------------------------------------------------------------
# lws-tpu monitor: the history-plane view — per-series sparklines, burn
# columns, firing alerts, the current scale recommendation, and the ACT
# column (last actuation per plane).

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values: list, width: int = 24) -> str:
    """Unicode sparkline of the trailing `width` values, min-max
    normalized (a flat series renders flat, not empty)."""
    values = [v for v in values if v is not None][-width:]
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(values)
    return "".join(
        _SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1,
                          int((v - lo) / span * (len(_SPARK_BLOCKS) - 0.001)))]
        for v in values
    )


def _series_cells(kind: str, points: list) -> tuple[list, str]:
    """(plotted values, unit suffix) for one retained series: counters plot
    their successive per-second rates (a cumulative line is always just
    'up'), gauges plot raw values."""
    if kind != "counter":
        return [v for _, v in points], ""
    vals = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        if t1 > t0:
            vals.append(max(0.0, v1 - v0) / (t1 - t0))
    return vals, "/s"


def render_monitor(snapshot: dict, fams: dict | None = None,
                   alerts: dict | None = None, now: float | None = None,
                   top_n: int = 24, name_filter: str = "",
                   top_k: int = 40, decisions: list | None = None) -> str:
    """One frame of `lws-tpu monitor`: the /debug/history snapshot's series
    as sparklines (counters as rates, gauges raw), the burn-rate and
    scale-recommendation gauges folded from the metrics surface, the ACT
    column (last actuation per plane, from /debug/decisions), and the
    firing alerts. Pure function of its inputs so tests drive it from
    canned data. `top_k` bounds the burn table to the hottest rows
    (highest burn first, truncation footer; 0 unbounded) — the fleet
    surface carries one burn row per (instance, engine, window) at scale."""
    series = snapshot.get("series") or []
    header = (
        f"MONITOR  series={snapshot.get('series_total', len(series))}"
        f"  interval={snapshot.get('interval_s', '-')}s"
        f"  retention={snapshot.get('retention_s', '-')}s"
    )
    firing = sorted((alerts or {}).keys())
    header += f"  alerts={','.join(firing) if firing else 'none'}"
    lines = [header]
    for name, details in sorted((alerts or {}).items()):
        for d in details:
            lines.append(f"  ALERT {name}: {json.dumps(d)}")
    lines.extend(_act_lines(decisions, now=now))
    # The recommendation + burn gauges ride the normal metrics surface
    # (obs/recommend.py publishes them like any other sensor).
    if fams:
        rec = {
            labels.get("role", "-"): value
            for name, labels, value, _ in
            fams.get("serving_scale_recommendation", {}).get("samples", [])
            if name == "serving_scale_recommendation"
        }
        if rec:
            cells = "  ".join(f"{role}={int(v)}" for role, v in sorted(rec.items()))
            lines.append(f"recommendation: {cells}")
        burns = [
            (labels, value)
            for name, labels, value, _ in
            fams.get("serving_slo_burn_rate", {}).get("samples", [])
            if name == "serving_slo_burn_rate"
        ]
        if burns:
            lines.append("")
            lines.append(f"{'BURN SERIES':<28}{'WINDOW':<8}{'BURN':>8}")
            # Hottest first, bounded: the burning rows must survive the
            # bound, the calm tail is what the footer elides.
            burns.sort(key=lambda b: (-b[1],
                                      b[0].get("engine", ""),
                                      b[0].get("klass", ""),
                                      b[0].get("window", "")))
            hidden = burns[top_k:] if top_k else []
            for labels, value in (burns[:top_k] if top_k else burns):
                key = labels.get("engine", "-")
                if labels.get("klass"):
                    key += "/" + labels["klass"]
                if labels.get("instance"):
                    key += "@" + labels["instance"]
                lines.append(
                    f"{key:<28}{labels.get('window', '-'):<8}{value:>7.1f}x"
                )
            if hidden:
                shown_inst = {
                    l.get("instance", "-") for l, _ in burns[:top_k]
                }
                hidden_inst = {
                    l.get("instance", "-") for l, _ in hidden
                } - shown_inst
                what = (f"{len(hidden_inst)} more instances"
                        if hidden_inst else f"{len(hidden)} more rows")
                lines.append(f"… {what} (raise --top-k)")
    lines.append("")
    lines.append(f"{'SERIES':<58}{'LAST':>12}  TREND")
    shown = 0
    skipped = 0
    for s in series:
        name = s.get("name", "")
        if name.endswith(("_bucket", "_sum")):
            continue  # bucket/sum decompositions: noise at this altitude
        labels = s.get("labels") or {}
        label_txt = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        full = f"{name}{{{label_txt}}}" if label_txt else name
        if name_filter and name_filter not in full:
            continue
        if shown >= top_n:
            skipped += 1
            continue
        vals, unit = _series_cells(s.get("kind", "gauge"), s.get("points") or [])
        lastv = vals[-1] if vals else None
        cell = f"{lastv:.4g}{unit}" if lastv is not None else "-"
        lines.append(f"{full[:58]:<58}{cell:>12}  {_sparkline(vals)}")
        shown += 1
    if skipped or snapshot.get("truncated"):
        lines.append(
            f"... {skipped + int(snapshot.get('truncated') or 0)} more series"
            " (raise --limit / narrow the filter)"
        )
    return "\n".join(lines)


def _fetch_monitor_state(server: str) -> tuple[dict, dict]:
    """(parsed metric families, active alerts) for the monitor frame. The
    fleet surface wins when the server has one (the API server); a worker
    telemetry port degrades to its own /metrics. Alerts merge the watchdog
    gauges riding the exposition with the live /debug/flightrecorder
    detail, exactly like `lws-tpu top`."""
    from lws_tpu_torch.core.metrics import parse_exposition

    fams: dict = {}
    for path in ("/metrics/fleet", "/metrics"):
        url = f"{_server_base(server)}{path}"
        req = urllib.request.Request(url, headers=_auth_headers())
        try:
            with urllib.request.urlopen(req, timeout=30,
                                        context=_url_context(url)) as resp:
                fams = parse_exposition(resp.read().decode())
            break
        except urllib.error.HTTPError:
            continue  # worker port: no fleet surface — fall back
    alerts: dict = {}
    for name, labels, value, _ in fams.get("lws_watchdog_active", {}).get("samples", []):
        if name == "lws_watchdog_active" and value >= 1.0:
            alerts.setdefault(labels.get("watchdog", "?"), []).append(
                {"instance": labels.get("instance", "-")}
            )
    try:
        fr = _http(server, "GET", "/debug/flightrecorder?limit=0")
        for name, details in (fr.get("alerts") or {}).items():
            alerts[name] = details
    except SystemExit:
        pass
    return fams, alerts


def cmd_monitor(args) -> int:
    """History-plane view: the server's retained series (/debug/history) as
    sparklines, the burn-rate columns and current scale recommendation from
    its metrics surface, the last actuation per decision plane (ACT lines,
    from /debug/decisions), and firing watchdog alerts. One-shot by
    default; --watch redraws every --interval seconds."""
    args.interval = max(args.interval, 1.0)
    while True:
        snap = _http(args.server, "GET", f"/debug/history?limit={args.limit}")
        try:
            fams, alerts = _fetch_monitor_state(args.server)
        except urllib.error.URLError as e:
            raise SystemExit(
                f"error: cannot reach server {args.server}: {e.reason}"
            ) from None
        decisions = _fetch_decisions(args.server)
        frame = render_monitor(snap, fams, alerts, top_n=args.top,
                               name_filter=args.filter or "",
                               top_k=getattr(args, "top_k", 40),
                               decisions=decisions)
        if not args.watch:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


# ---------------------------------------------------------------------------
# lws-tpu explain: request-journey forensics — one request's cross-process
# waterfall (phases with self-time, wire chunks, retries) and a one-line
# verdict naming the phase that blew the budget (lws_tpu_torch/obs/journey.py).


def _explain_verdict(journey: dict) -> dict:
    """The verdict for a (possibly fleet-joined) journey record: the first
    leg whose timeline breached names the phase; a joined record without
    leg timelines falls back to its merged flags."""
    from lws_tpu_torch.obs.journey import verdict

    fallback = None
    for leg in journey.get("legs") or []:
        v = verdict(leg.get("journey") or {})
        instance = (leg.get("labels") or {}).get("instance", "-")
        if not v["ok"]:
            v["text"] += f"  [leg {instance}]"
            return v
        if (leg.get("journey") or {}).get("timeline"):
            fallback = v
    return fallback if fallback is not None else verdict(journey)


def render_request_index(rows: list) -> str:
    """The `lws-tpu explain --slowest/--breached/--errored` table: retained
    journeys worst-first, each row explainable by id."""
    lines = [
        f"{'REQUEST':<22}{'OUTCOME':<18}{'KLASS':<10}{'ENGINE':<8}"
        f"{'TTFT':>9}{'TOTAL':>9}{'SPANS':>7}{'REVISION':>12}  INSTANCE",
    ]

    def fmt(v, pattern="{:.3f}s"):
        return pattern.format(v) if v is not None else "-"

    for row in rows:
        lines.append(
            f"{str(row.get('id', '-'))[:21]:<22}"
            f"{str(row.get('outcome', '-')):<18}"
            f"{str(row.get('klass') or '-'):<10}"
            f"{str(row.get('engine') or '-'):<8}"
            f"{fmt(row.get('ttft_s')):>9}"
            f"{fmt(row.get('total_s')):>9}"
            f"{row.get('spans', 0):>7}"
            f"{str(row.get('revision') or '-')[:11]:>12}"
            f"  {row.get('instance', '-')}"
        )
    if len(lines) == 1:
        lines.append("(no retained journeys matched)")
    return "\n".join(lines)


def render_explain(journey: dict, bar_width: int = 28) -> str:
    """One `lws-tpu explain <id>` frame: the journey's span tree as a
    waterfall (offset bars on a shared clock, per-span self-time), the
    KV-stream chunk timeline, the resilience events that touched the
    request, and the verdict. Pure function of the journey record so tests
    drive it from canned data."""
    spans = list(journey.get("spans") or [])
    lines = [
        f"JOURNEY {journey.get('id', '-')}"
        f"  outcome={journey.get('outcome', '-')}"
        f"  flags={','.join(journey.get('flags') or []) or '-'}"
        f"  trace={str(journey.get('trace_id') or '-')[:16]}"
        f"  spans={len(spans)}"
        + ("  connected" if journey.get("connected") else ""),
    ]
    legs = journey.get("legs") or []
    if legs:
        lines.append("legs: " + ", ".join(
            "{}{}".format(
                (leg.get("labels") or {}).get("instance", "-"),
                " [{}]".format((leg.get("labels") or {}).get("role"))
                if (leg.get("labels") or {}).get("role") else "",
            )
            for leg in legs
        ))
    if spans:
        t0 = min(s.get("start_unix", 0.0) for s in spans)
        t_end = max(
            s.get("start_unix", 0.0) + s.get("duration_s", 0.0) for s in spans
        )
        total = max(t_end - t0, 1e-9)
        by_id = {s.get("span_id"): s for s in spans}
        children: dict = {}
        for s in spans:
            children.setdefault(s.get("parent_id"), []).append(s)
        for kids in children.values():
            kids.sort(key=lambda s: s.get("start_unix", 0.0))
        roots = sorted(
            (s for s in spans if s.get("parent_id") not in by_id),
            key=lambda s: s.get("start_unix", 0.0),
        )
        lines.append("")
        lines.append(
            f"WATERFALL (total {total:.4f}s)"
        )
        lines.append(
            f"{'SPAN':<34}{'INSTANCE':<16}{'START':>9}{'SELF':>9}"
            f"{'TOTAL':>9}  TIMELINE"
        )

        def bar(start: float, dur: float) -> str:
            lo = int((start - t0) / total * bar_width)
            hi = int((start + dur - t0) / total * bar_width)
            hi = max(hi, lo + 1)
            return " " * lo + "█" * (hi - lo)

        def walk(span: dict, depth: int) -> None:
            dur = span.get("duration_s", 0.0)
            kids = children.get(span.get("span_id"), [])
            self_s = max(0.0, dur - sum(k.get("duration_s", 0.0) for k in kids))
            name = "  " * depth + str(span.get("name", "-"))
            status = "!" if span.get("status") == "error" else ""
            lines.append(
                f"{(name + status)[:33]:<34}"
                f"{str(span.get('instance', '-'))[:15]:<16}"
                f"{span.get('start_unix', 0.0) - t0:>8.4f}s"
                f"{self_s:>8.4f}s"
                f"{dur:>8.4f}s"
                f"  {bar(span.get('start_unix', 0.0), dur)}"
            )
            for kid in kids:
                walk(kid, depth + 1)

        for root in roots:
            walk(root, 0)
    chunks = (journey.get("annotations") or {}).get("chunks") or []
    if chunks:
        arrivals = " ".join(f"+{c.get('t_s', 0.0):.3f}s" for c in chunks)
        nbytes = sum(int(c.get("bytes", 0)) for c in chunks)
        lines.append("")
        lines.append(
            f"wire chunks: {len(chunks)} ({nbytes} B) arrivals {arrivals}"
        )
    compiles = (journey.get("annotations") or {}).get("compiles") or []
    if compiles:
        # The compile ledger annotated this request: XLA paid compile time
        # on its critical path (lws_tpu_torch/obs/device.py) — the forensic
        # detail behind a "phase: compile" verdict.
        lines.append("")
        for c in compiles[:8]:
            lines.append(
                f"compile {c.get('kind', '?')}: {c.get('executable', '?')}"
                f" shape={c.get('shape') or '-'}"
                f" {float(c.get('seconds') or 0.0):.4f}s"
            )
        if len(compiles) > 8:
            lines.append(f"... {len(compiles) - 8} more compiles")
    events = journey.get("events") or []
    if events:
        lines.append("")
        for ev in events[:12]:
            detail = " ".join(
                f"{k}={ev[k]}" for k in ("site", "point", "mode", "endpoint",
                                         "to_state", "attempt", "error")
                if ev.get(k) is not None
            )
            lines.append(f"event {ev.get('kind', '-')}: {detail}")
        if len(events) > 12:
            lines.append(f"... {len(events) - 12} more events")
    lines.append("")
    lines.append(f"VERDICT: {_explain_verdict(journey)['text']}")
    return "\n".join(lines)


def cmd_explain(args) -> int:
    """Request-journey forensics: fetch one request's (fleet-joined)
    journey from /debug/request/{id} and render the cross-process waterfall
    + verdict; or list the worst retained journeys (--slowest / --breached
    / --errored) from /debug/requests so an operator picks an offender."""
    from urllib.parse import quote, urlencode

    picked = [o for o, on in (("slowest", args.slowest),
                              ("breached", args.breached),
                              ("errored", args.errored)) if on]
    if len(picked) > 1:
        print("error: pick ONE of --slowest/--breached/--errored",
              file=sys.stderr)
        return 2
    if picked:
        query = {"outcome": picked[0], "limit": args.limit}
        if args.klass:
            query["klass"] = args.klass
        if args.revision:
            query["revision"] = args.revision
        rows = _http(args.server, "GET",
                     f"/debug/requests?{urlencode(query)}")
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            print(render_request_index(rows))
        return 0
    if not args.request_id:
        print("error: a request id (or --slowest/--breached/--errored) is "
              "required", file=sys.stderr)
        return 2
    body = _http(args.server, "GET",
                 f"/debug/request/{quote(args.request_id, safe='')}")
    if args.json:
        print(json.dumps(body, indent=1))
    else:
        print(render_explain(body))
    return 0


# ---------------------------------------------------------------------------
# lws-tpu rollout: the rollout intelligence plane — the control-plane
# timeline ledger (/debug/rollout) plus the per-revision SLO comparison and
# the canary verdicts the analyzer publishes on the fleet surface (and the
# RolloutActuator acts on; lws_tpu_torch/obs/rollout.py, obs/decisions.py).


_VERDICT_NAMES = {1.0: "promote", 0.0: "hold", -1.0: "rollback"}


def render_rollout(entries: list, fams: dict, alerts: dict,
                   max_timeline: int = 32, decisions: list | None = None,
                   now: float | None = None) -> str:
    """One `lws-tpu rollout` frame: the per-revision comparison table
    (verdict gauge + revision-scoped burn twins + goodput folded from the
    fleet exposition's revision labels), the ACT column (last actuation per
    plane, from /debug/decisions), firing alerts, and the ledger timeline
    newest-last. Pure function of the fetched state so tests drive it from
    canned data."""

    def samples(family: str):
        return [
            (labels, value)
            for name, labels, value, _ in fams.get(family, {}).get("samples", [])
            if name == family
        ]

    revs: dict[str, dict] = {}
    lws = "-"
    for labels, value in samples("lws_rollout_canary_verdict"):
        slot = revs.setdefault(labels.get("revision", "-"), {})
        slot["verdict"] = _VERDICT_NAMES.get(value, f"{value:g}")
        lws = labels.get("lws", lws)
    for labels, value in samples("serving_slo_burn_rate_by_revision"):
        slot = revs.setdefault(labels.get("revision", "-"), {})
        key = f"burn_{labels.get('window', '-')}"
        slot[key] = max(value, slot.get(key, float("-inf")))
    totals: dict[str, float] = {}
    goods: dict[str, float] = {}
    for family, acc in (("serving_tokens_total", totals),
                        ("serving_goodput_tokens_total", goods)):
        for labels, value in samples(family):
            rev = labels.get("revision") or "-"
            acc[rev] = acc.get(rev, 0.0) + value
    for rev, tok in totals.items():
        slot = revs.setdefault(rev, {})
        slot["tokens"] = tok
        slot["good"] = goods.get(rev, 0.0) / tok if tok > 0 else None

    def fmt(v, pattern="{:.1f}x"):
        return pattern.format(v) if v is not None else "-"

    lines = [
        f"ROLLOUT  lws={lws}  revisions={len(revs)}",
        "",
        f"{'REVISION':<16}{'VERDICT':>10}{'FAST':>8}{'SLOW':>8}"
        f"{'GOOD%':>8}{'TOKENS':>10}",
    ]
    for rev in sorted(revs):
        s = revs[rev]
        lines.append(
            f"{rev[:15]:<16}{s.get('verdict', '-'):>10}"
            f"{fmt(s.get('burn_fast')):>8}{fmt(s.get('burn_slow')):>8}"
            f"{fmt(s.get('good'), '{:.0%}'):>8}"
            f"{s.get('tokens', 0):>10.0f}"
        )
    if len(revs) == 0:
        lines.append("(no revision-labelled serving series yet)")
    act = _act_lines(decisions, now=now)
    if act:
        lines.append("")
        lines.extend(act)
    if alerts:
        lines.append("")
        for name in sorted(alerts):
            lines.append(f"ALERT {name}: {json.dumps(alerts[name], default=str)}")
    lines.append("")
    lines.append(f"TIMELINE (newest last, {min(len(entries), max_timeline)}"
                 f" of {len(entries)})")
    for e in entries[-max_timeline:]:
        ts = time.strftime("%H:%M:%S", time.localtime(e.get("unix", 0.0)))
        detail = " ".join(
            f"{k}={v}" for k, v in sorted((e.get("detail") or {}).items())
        )
        lines.append(
            f"{ts}  {str(e.get('kind', '-')):<22}"
            f"{str(e.get('object') or '-'):<30}"
            f"{str(e.get('revision') or '-')[:12]:<14}{detail}"
        )
    if not entries:
        lines.append("(ledger empty — no control-plane transitions recorded)")
    return "\n".join(lines)


def cmd_rollout(args) -> int:
    """Rollout intelligence: the control-plane transition timeline
    (/debug/rollout), the per-revision SLO comparison table, the canary
    verdicts (`lws_rollout_canary_verdict`) the analyzer refreshes on every
    fleet scrape, and the last actuation per decision plane (ACT lines).
    One-shot by default; --watch redraws every --interval seconds;
    --timeline-only skips the metrics fetch."""
    args.interval = max(args.interval, 1.0)
    while True:
        entries = _http(args.server, "GET",
                        f"/debug/rollout?limit={args.limit}")
        fams: dict = {}
        alerts: dict = {}
        if not args.timeline_only:
            try:
                fams, alerts = _fetch_monitor_state(args.server)
            except urllib.error.URLError as e:
                raise SystemExit(
                    f"error: cannot reach server {args.server}: {e.reason}"
                ) from None
        decisions = _fetch_decisions(args.server)
        if args.json:
            print(json.dumps({"timeline": entries, "alerts": alerts,
                              "decisions": decisions},
                             indent=1, default=str))
            return 0
        frame = render_rollout(entries, fams, alerts,
                               max_timeline=args.limit,
                               decisions=decisions)
        if not args.watch:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


# ---------------------------------------------------------------------------
# lws-tpu why: decision forensics — one actuation decision's full evidence
# chain (burn window → guards → verdict → actuation → convergence) from the
# DecisionLedger served at /debug/decisions (lws_tpu_torch/obs/decisions.py),
# the way `explain` renders a request.


def _fmt_age(seconds: float) -> str:
    if seconds < 120:
        return f"{seconds:.0f}s"
    if seconds < 7200:
        return f"{seconds / 60:.0f}m"
    return f"{seconds / 3600:.1f}h"


def _fetch_decisions(server: str, limit: int = 64) -> list:
    """Best-effort /debug/decisions window for the ACT column — a server
    predating the decision plane (or a worker port behind auth) degrades
    to no ACT lines, not a failed frame."""
    try:
        rows = _http(server, "GET", f"/debug/decisions?limit={limit}")
        return rows if isinstance(rows, list) else []
    except SystemExit:
        return []


def _last_actuations(decisions: list) -> dict:
    """{plane: record} — the newest record carrying an actuation outcome
    per plane, folded from a newest-last /debug/decisions window (the
    client-side mirror of `DecisionLedger.last_actuation`)."""
    out: dict = {}
    for rec in decisions or []:
        if rec.get("action"):
            out[rec.get("plane", "-")] = rec
    return out


def _act_lines(decisions: list | None, now: float | None = None) -> list:
    """The ACT column `lws-tpu monitor` and `lws-tpu rollout` share: one
    line per decision plane with the last actuation's action, outcome,
    subject, age, and decision id (the handle `lws-tpu why` takes)."""
    if now is None:
        now = time.time()
    lines = []
    last = _last_actuations(decisions or [])
    for plane in sorted(last):
        rec = last[plane]
        acted = rec.get("acted_at")
        age = _fmt_age(max(0.0, now - acted)) if acted is not None else "-"
        detail = rec.get("detail") or {}
        if detail.get("superseded_by"):
            state = f"superseded by {detail['superseded_by']}"
        elif rec.get("convergence_s") is not None:
            state = f"converged {rec['convergence_s']:.1f}s"
        elif rec.get("outcome") == "applied":
            state = "converging"
        else:
            state = ""
        if detail.get("flap"):
            state = (state + "  FLAP").strip()
        lines.append(
            f"ACT {plane:<8} {str(rec.get('action', '-')):<10}"
            f"{str(rec.get('outcome', '-')):<11}"
            f"{str(rec.get('subject', '-'))[:20]:<21}"
            f"{age:>5} ago  [{rec.get('id', '-')}]"
            + (f"  {state}" if state else "")
        )
    return lines


def render_why(record: dict, now: float | None = None) -> str:
    """One `lws-tpu why <decision-id>` frame: the decision's evidence chain
    end to end — the burn-window/ring inputs that drove the verdict, each
    guard's pass/fail, the actuation outcome with the target's store
    generations, and convergence. Pure function of the /debug/decisions
    record so tests drive it from canned data."""
    if now is None:
        now = time.time()
    detail = record.get("detail") or {}
    head = (
        f"DECISION {record.get('id', '-')}"
        f"  plane={record.get('plane', '-')}"
        f"  subject={record.get('subject', '-')}"
        f"  verdict={record.get('verdict', '-')}"
    )
    if record.get("repeats"):
        head += f"  repeats={record['repeats']}"
    lines = [head]
    at = record.get("at")
    if at is not None:
        lines.append(
            f"at {time.strftime('%H:%M:%S', time.localtime(at))}"
            f"  ({_fmt_age(max(0.0, now - at))} ago)"
        )

    inputs = record.get("inputs") or {}
    lines.append("")
    lines.append("EVIDENCE")
    if inputs.get("reason"):
        lines.append(f"  reason: {inputs['reason']}")
    if inputs.get("current") is not None or inputs.get("desired") is not None:
        lines.append(f"  replicas: current={inputs.get('current', '-')}"
                     f" desired={inputs.get('desired', '-')}")
    if inputs.get("firing"):
        lines.append(f"  firing: {', '.join(inputs['firing'])}")
    burns = inputs.get("burns") or []
    if burns:
        lines.append(f"  {'BURN SERIES':<30}{'WINDOW':<8}{'SHORT':>8}"
                     f"{'LONG':>8}{'THRESH':>8}  FIRING")
        def burn(v):
            # A window without data yet has no burn (None): the JAX
            # package's render raises on it; the port prints "-".
            return f"{v:>7.1f}x" if isinstance(v, (int, float)) else f"{'-':>8}"

        for b in burns[:12]:
            key = str(b.get("series", "-"))
            if b.get("instance"):
                key += "@" + str(b["instance"])
            lines.append(
                f"  {key[:29]:<30}{str(b.get('window', '-')):<8}"
                f"{burn(b.get('short_burn', 0.0))}"
                f"{burn(b.get('long_burn', 0.0))}"
                f"{b.get('threshold', 0.0):>7.1f}x"
                f"  {'yes' if b.get('firing') else 'no'}"
            )
        if len(burns) > 12:
            lines.append(f"  ... {len(burns) - 12} more burn rows")
    verdicts = inputs.get("verdicts") or {}
    if verdicts:
        if inputs.get("baseline"):
            lines.append(f"  baseline: {inputs['baseline']}")

        def x(v):
            return f"{v:.1f}x" if isinstance(v, (int, float)) else "-"

        lines.append(f"  {'REVISION':<16}{'VERDICT':>10}{'SHORT':>8}"
                     f"{'LONG':>8}{'BASE':>8}  REASON")
        for rev in sorted(verdicts):
            v = verdicts[rev] or {}
            lines.append(
                f"  {rev[:15]:<16}{str(v.get('verdict', '-')):>10}"
                f"{x(v.get('short_burn')):>8}{x(v.get('long_burn')):>8}"
                f"{x(v.get('baseline_burn')):>8}  {v.get('reason', '-')}"
            )
    if not (inputs.get("reason") or burns or verdicts):
        lines.append("  (no recorded inputs)")

    lines.append("")
    lines.append("GUARDS")
    guards = record.get("guards") or []
    for g in guards:
        mark = "pass" if g.get("passed") else "FAIL"
        lines.append(f"  [{mark}] {str(g.get('name', '-')):<18}"
                     f"{g.get('detail', '')}")
    if not guards:
        lines.append("  (none recorded)")

    lines.append("")
    lines.append("ACTUATION")
    if record.get("action"):
        acted = record.get("acted_at")
        line = f"  {record['action']} -> {record.get('outcome', '-')}"
        if acted is not None:
            line += f"  at {time.strftime('%H:%M:%S', time.localtime(acted))}"
        lines.append(line)
        gb = record.get("generation_before")
        ga = record.get("generation_after")
        if gb is not None or ga is not None:
            lines.append(
                f"  target generation: {gb if gb is not None else '?'}"
                f" -> {ga if ga is not None else '?'}"
            )
        kv = " ".join(
            f"{k}={json.dumps(detail[k]) if isinstance(detail[k], (dict, list)) else detail[k]}"
            for k in sorted(detail) if k not in ("flap", "superseded_by")
        )
        if kv:
            lines.append(f"  {kv}")
        if detail.get("flap"):
            lines.append("  FLAP: this actuation reversed direction inside"
                         " the flap window")
    else:
        lines.append("  (not acted on — verdict recorded only)")

    lines.append("")
    if detail.get("superseded_by"):
        lines.append(f"CONVERGENCE: superseded by {detail['superseded_by']}"
                     " before the fleet settled")
    elif record.get("convergence_s") is not None:
        lines.append(f"CONVERGENCE: fleet settled "
                     f"{record['convergence_s']:.2f}s after actuation")
    elif record.get("outcome") == "applied":
        lines.append("CONVERGENCE: pending — the fleet has not settled on"
                     " the decided state yet")
    else:
        lines.append("CONVERGENCE: n/a (nothing was applied)")
    return "\n".join(lines)


def cmd_why(args) -> int:
    """Decision forensics: fetch the /debug/decisions window, pick the
    decision (by id, or `last` / `last:scale` / `last:rollout` for the
    most recent actuation), and render its full evidence chain."""
    decisions = _http(args.server, "GET",
                      f"/debug/decisions?limit={max(args.limit, 1)}")
    if not isinstance(decisions, list):
        decisions = []
    wanted = args.decision_id
    record = None
    if wanted == "last" or wanted.startswith("last:"):
        _, _, plane = wanted.partition(":")
        acted = _last_actuations(decisions)
        if plane:
            record = acted.get(plane)
        elif acted:
            record = max(acted.values(),
                         key=lambda r: r.get("acted_at") or 0.0)
        if record is None:
            # Nothing acted yet: fall back to the newest verdict so `last`
            # still explains a record-only fleet.
            pool = [r for r in decisions
                    if not plane or r.get("plane") == plane]
            record = pool[-1] if pool else None
    else:
        record = next((r for r in decisions if r.get("id") == wanted), None)
    if record is None:
        print(f"error: decision '{wanted}' is not in the retained window "
              f"({len(decisions)} records fetched; raise --limit, or pick "
              "an id from `lws-tpu monitor`'s ACT lines)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(record, indent=1))
        return 0
    print(render_why(record))
    return 0


def render_profile(instances: list, top_n: int = 15) -> str:
    """One frame of `lws-tpu profile`: per-span self-time and top-of-stack
    tables folded from /debug/profile snapshots. `instances` is
    [(instance_name, snapshot)] — one entry for a single-process fetch, one
    per worker for the fleet surface. Pure function of the snapshots so
    tests drive it from canned stacks."""
    from lws_tpu_torch.core.profile import fold_by_span, top_frames

    total = sum(s.get("samples", 0) for _, s in instances)
    sampling = "on" if any(s.get("enabled") for _, s in instances) else "off"
    lines = [
        f"PROFILE  instances={len(instances)}  samples={total}  sampling={sampling}",
        "",
        f"{'INSTANCE':<18}{'SPAN':<28}{'SAMPLES':>9}{'SELF%':>7}",
    ]
    for name, snap in instances:
        folded = sorted(
            fold_by_span(snap.get("stacks", [])).items(), key=lambda kv: -kv[1]
        )
        denom = sum(c for _, c in folded) or 1  # limit-truncated totals
        for span_name, count in folded[:top_n]:
            lines.append(
                f"{name:<18}{span_name:<28}{count:>9}{count / denom:>7.0%}"
            )
    lines.append("")
    lines.append(f"{'TOP OF STACK':<46}{'SAMPLES':>9}{'SELF%':>7}")
    merged: dict = {}
    for _, snap in instances:
        for frame, count in top_frames(snap.get("stacks", [])).items():
            merged[frame] = merged.get(frame, 0) + count
    denom = sum(merged.values()) or 1
    for frame, count in sorted(merged.items(), key=lambda kv: -kv[1])[:top_n]:
        lines.append(f"{frame[-46:]:<46}{count:>9}{count / denom:>7.0%}")
    return "\n".join(lines)


def cmd_profile(args) -> int:
    """Where the time went: fetch `/debug/profile` (or the instance-labelled
    merge at `/debug/profile/fleet` with --fleet) and render per-span plus
    top-of-stack self-time tables. --collapsed dumps the raw Brendan-Gregg
    collapsed stacks instead — pipeable straight into flamegraph.pl."""
    path = "/debug/profile/fleet" if args.fleet else "/debug/profile"
    if args.collapsed:
        if args.watch:
            raise SystemExit(
                "error: --collapsed is a one-shot dump for flamegraph "
                "tooling; drop --watch"
            )
        url = (f"{_server_base(args.server)}{path}"
               f"?format=collapsed&limit={args.limit}")
        req = urllib.request.Request(url, headers=_auth_headers())
        try:
            with urllib.request.urlopen(req, timeout=30, context=_url_context(url)) as resp:
                sys.stdout.write(resp.read().decode())
        except urllib.error.HTTPError as e:
            # Same error surfacing as _http(): the server WAS reached — show
            # its detail (bad limit, missing token), not "cannot reach".
            detail = e.read().decode()
            try:
                detail = json.loads(detail).get("error", detail)
            except (ValueError, AttributeError):
                pass
            raise SystemExit(f"error: {e.code}: {detail}") from None
        except urllib.error.URLError as e:
            raise SystemExit(
                f"error: cannot reach server {args.server}: {e.reason}"
            ) from None
        return 0
    args.interval = max(args.interval, 1.0)
    while True:
        body = _http(args.server, "GET", f"{path}?limit={args.limit}")
        if args.fleet:
            instances = [
                (entry.get("labels", {}).get("instance", "-"), entry["profile"])
                for entry in body.get("instances", [])
            ]
        else:
            instances = [("-", body)]
        frame = render_profile(instances, top_n=args.top)
        if not args.watch:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


def _pool_rows(fams: dict) -> dict:
    """{instance: {pool: bytes}} folded from `serving_hbm_pool_bytes` on a
    fleet exposition — pure function so tests drive it from canned text."""
    out: dict = {}
    for name, labels, value, _ in fams.get(
            "serving_hbm_pool_bytes", {}).get("samples", []):
        if name != "serving_hbm_pool_bytes":
            continue
        row = out.setdefault(labels.get("instance", "-"), {})
        pool = labels.get("pool", "?")
        row[pool] = row.get(pool, 0.0) + value
    return out


def render_devices(compile_body: dict, pools: dict | None = None,
                   top_n: int = 10) -> str:
    """One frame of `lws-tpu devices`: per-instance HBM pool attribution,
    the fleet per-executable compile fold (recompile-heavy first — those
    are the rows costing steady-state wall-clock), and the recent ledger
    tail (newest last). Pure function of a /debug/compile[/fleet] body and
    a `_pool_rows` fold so tests drive it from canned dicts."""
    instances = compile_body.get("instances", [])
    execs = compile_body.get("executables", {})
    storming = sorted({
        name for e in instances
        for name in ((e.get("compile") or {}).get("storms") or {})
    })
    lines = [
        f"DEVICES  instances={len(instances)}  executables={len(execs)}"
        f"  storms={','.join(storming) if storming else 'none'}"
    ]
    if pools:
        lines.append("")
        lines.append(f"{'INSTANCE':<18}{'WEIGHTS_MB':>11}{'KV_MB':>8}"
                     f"{'ARENA_MB':>10}{'WORK_MB':>9}")
        for inst in sorted(pools):
            p = pools[inst]

            def mb(pool):
                v = p.get(pool)
                return f"{v / 1e6:.0f}" if v is not None else "-"

            lines.append(f"{inst:<18}{mb('weights'):>11}{mb('kv'):>8}"
                         f"{mb('arena_restore'):>10}{mb('workspace'):>9}")
    lines.append("")
    lines.append(f"{'EXECUTABLE':<34}{'FIRST':>6}{'RECOMP':>7}"
                 f"{'SECONDS':>9}{'INSTANCES':>10}")
    table = sorted(execs.items(),
                   key=lambda kv: (-int(kv[1].get("recompiles") or 0),
                                   -float(kv[1].get("seconds") or 0.0)))
    for name, agg in (table[:top_n] if top_n else table):
        lines.append(f"{name[-34:]:<34}{int(agg.get('first') or 0):>6}"
                     f"{int(agg.get('recompiles') or 0):>7}"
                     f"{float(agg.get('seconds') or 0.0):>9.2f}"
                     f"{int(agg.get('instances') or 1):>10}")
    recent = []
    for entry in instances:
        inst = (entry.get("labels") or {}).get("instance", "-")
        for rec in (entry.get("compile") or {}).get("records", []):
            recent.append((float(rec.get("unix") or 0.0), inst, rec))
    recent.sort(key=lambda t: t[0])
    if recent:
        lines.append("")
        lines.append(f"{'INSTANCE':<18}{'KIND':<10}{'EXECUTABLE':<26}"
                     f"{'SHAPE':<14}{'SECONDS':>9}")
        for _, inst, rec in (recent[-top_n:] if top_n else recent):
            lines.append(f"{inst:<18}{rec.get('kind', '?'):<10}"
                         f"{(rec.get('executable') or '?')[-26:]:<26}"
                         f"{(rec.get('shape') or '-')[:14]:<14}"
                         f"{float(rec.get('seconds') or 0.0):>9.3f}")
    return "\n".join(lines)


def cmd_devices(args) -> int:
    """Device-runtime view: which executables keep recompiling (and where),
    how much wall-clock they cost, and how each instance's HBM splits
    across the weights/kv/arena_restore/workspace pools. Prefers the
    control plane's fleet fold (`/debug/compile/fleet` + the fleet
    exposition's pool gauges); a bare worker telemetry server degrades to
    its single-instance ledger. One-shot by default; --watch redraws;
    --json dumps the raw fold for scripting."""
    from lws_tpu_torch.core.metrics import parse_exposition

    args.interval = max(args.interval, 1.0)
    while True:
        try:
            body = _http(args.server, "GET",
                         f"/debug/compile/fleet?limit={args.limit}")
        except SystemExit:
            local = _http(args.server, "GET",
                          f"/debug/compile?limit={args.limit}")
            body = {
                "instances": [{"labels": {"instance": "-"},
                               "compile": local}],
                "executables": {
                    name: {**agg, "instances": 1}
                    for name, agg in (local.get("executables") or {}).items()
                },
            }
        if args.json:
            print(json.dumps(body, indent=2, default=str))
            return 0
        pools = None
        try:
            url = f"{_server_base(args.server)}/metrics/fleet"
            req = urllib.request.Request(url, headers=_auth_headers())
            with urllib.request.urlopen(
                    req, timeout=30, context=_url_context(url)) as resp:
                pools = _pool_rows(parse_exposition(resp.read().decode()))
        except (urllib.error.URLError, OSError):
            pools = None  # bare telemetry server: compile tables only
        frame = render_devices(body, pools=pools, top_n=args.top)
        if not args.watch:
            print(frame)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


def cmd_faults(args) -> int:
    """Chaos controls against a live server's /debug/faults surface (API
    server or a worker's telemetry port): list the armed fault points, arm
    `point=spec` schedules (core/faults.py grammar, e.g.
    `kv.ack=drop:1`), disarm/clear them, or request a graceful drain
    (`--drain` posts /debug/drain — worker telemetry servers only)."""
    if args.drain:
        out = _http(args.server, "POST", "/debug/drain", b"{}")
        print(json.dumps(out, indent=1))
        return 0
    payload: dict = {}
    if args.clear:
        payload["clear"] = True
    arm = {}
    for spec in args.points:
        point, sep, schedule = spec.partition("=")
        if not sep or not point or not schedule:
            print(f"error: bad fault spec {spec!r}; expected point=spec "
                  "(e.g. kv.ack=drop:1)", file=sys.stderr)
            return 2
        arm[point] = schedule
    if arm:
        payload["arm"] = arm
    if payload:
        out = _http(args.server, "POST", "/debug/faults",
                    json.dumps(payload).encode())
    else:
        out = _http(args.server, "GET", "/debug/faults")
    print(json.dumps(out, indent=1))
    return 0


def _parse_endpoint(value: str) -> tuple[str, int]:
    host, sep, port = value.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"error: bad endpoint {value!r}; expected HOST:PORT")
    return (host or "127.0.0.1", int(port))


def _revision_bump_hook(server: str, bump: dict, time_scale: float):
    """The scenario's revision_bump stanza as a drive-loop hook: at
    `at_s` scenario-seconds it flips the deployment's worker-template env
    through the live server — a real mid-run rollout. The apply runs on a
    background thread (the drive loop is open-loop: a slow server must
    never delay an arrival); the hook only arms it once."""
    import threading

    def do_bump():
        try:
            if bump["lws"]:
                ns, _, name = bump["lws"].partition("/")
                obj = _http(server, "GET", f"/apis/leaderworkersets/{ns}/{name}")
            else:
                objs = _http(server, "GET", "/apis/leaderworkersets")
                if not objs:
                    print("warning: revision_bump found no LeaderWorkerSets to bump",
                          file=sys.stderr)
                    return
                obj = min(objs, key=lambda o: (o["metadata"]["namespace"],
                                               o["metadata"]["name"]))
            lwt = obj["spec"]["leader_worker_template"]
            for tmpl_key in ("worker_template", "leader_template"):
                tmpl = lwt.get(tmpl_key)
                if not tmpl:
                    continue
                for c in tmpl.get("spec", {}).get("containers", []):
                    env = [e for e in c.get("env", []) if e.get("name") != bump["env"]["name"]]
                    env.append(dict(bump["env"]))
                    c["env"] = env
            _http(server, "POST", "/apply", json.dumps(obj).encode())
            print(f"# revision bump applied to {obj['metadata']['namespace']}/"
                  f"{obj['metadata']['name']} at t>={bump['at_s']:g}s "
                  f"({bump['env']['name']}={bump['env']['value']})", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — a failed bump must not kill
            # the run; the report just shows one revision.
            print(f"warning: revision bump failed: {e}", file=sys.stderr)

    state = {"start": None, "fired": False}

    def on_tick(now):
        if state["start"] is None:
            state["start"] = now
        if not state["fired"] and now - state["start"] >= bump["at_s"] * time_scale:
            state["fired"] = True
            threading.Thread(target=do_bump, daemon=True).start()

    return on_tick


def cmd_loadgen(args) -> int:
    """Run a named traffic scenario (lws_tpu_torch/loadgen/) against a target
    and render the goodput report: seeded open-loop arrivals + workload mix
    -> per-class TTFT/ITL quantiles, SLO attainment, and the goodput
    fraction (tokens on time / tokens delivered). Targets: an in-process
    engine of the port (--target dense|batch|paged, the default; on the
    card unless --device says otherwise) or a LIVE pair of the port's
    disaggregated workers (--prefill/--decode KV endpoints). With --server,
    a sampler thread feeds a HistoryRing from that server's /metrics/fleet
    during the run, the report appends the history, canary and actuation
    blocks, and its fleet block folds GOODPUT%/PFX%/SPEC%/KV% out of the
    same surface."""
    from lws_tpu_torch import loadgen

    if args.list:
        for name in loadgen.scenario_names():
            print(loadgen.describe_scenario(loadgen.load_scenario(name)))
        return 0
    if not args.scenario and not args.spec:
        print("error: a scenario name (or --spec FILE) is required; "
              "--list shows the built-ins", file=sys.stderr)
        return 2
    spec = loadgen.load_scenario(args.spec or args.scenario)
    schedule = loadgen.build_schedule(spec, args.seed)
    targets = loadgen.install_class_targets(spec)
    digest = loadgen.schedule_digest(schedule)
    print(f"# {loadgen.describe_scenario(spec, schedule)} "
          f"(seed {args.seed}, schedule {digest[:12]})")
    if bool(args.prefill) != bool(args.decode):
        print("error: --prefill and --decode must be given together", file=sys.stderr)
        return 2
    if args.prefill:
        target = loadgen.DisaggTarget(_parse_endpoint(args.prefill),
                                      _parse_endpoint(args.decode))
    else:
        target = loadgen.build_local_target(args.target, spec, device=args.device)
    # With --server, a SAMPLER THREAD feeds a HistoryRing from the live
    # fleet surface for the run's duration (off the drive loop: a stalled
    # server must cost a sample gap, never delay an open-loop arrival).
    ring = None
    fleet_url = f"{_server_base(args.server)}/metrics/fleet" if args.server else ""
    if args.server:
        from lws_tpu_torch.obs.history import HistoryRing

        ring = HistoryRing(interval_s=0.5, retention_s=3600.0)

        def fetch_fleet_text() -> str:
            # Raises on failure: the ring's sampler thread skips that tick
            # — a gap in history, never a phantom empty sample.
            req = urllib.request.Request(fleet_url, headers=_auth_headers())
            with urllib.request.urlopen(req, timeout=2,
                                        context=_url_context(fleet_url)) as resp:
                return resp.read().decode()

        ring.start(fetch_fleet_text)
    bump = loadgen.revision_bump(spec)
    on_tick = None
    if bump is not None and not args.server:
        print("warning: scenario declares revision_bump but no --server; skipping the bump",
              file=sys.stderr)
    elif bump is not None:
        on_tick = _revision_bump_hook(args.server, bump, args.time_scale)
    try:
        result = loadgen.run_schedule(schedule, target, time_scale=args.time_scale,
                                      max_wall_s=args.max_wall, on_tick=on_tick)
    finally:
        if ring is not None:
            ring.stop()
    report = loadgen.summarize(result, targets, float(spec.get("horizon_s", 1.0)),
                               spec.get("name", args.scenario or "-"), args.seed)
    if ring is not None and ring.series():
        report["history"] = loadgen.fold_history(ring, targets)
        # Revision-labelled series in the ring (a rollout during the run):
        # the canary verdict trace.
        canary = loadgen.fold_canary(ring, lws=bump["lws"] if bump else "-")
        if canary is not None:
            report["canary"] = canary
        # Actuation counters in the ring: the server closed the loop.
        actuations = loadgen.fold_actuations(ring)
        if actuations is not None:
            report["actuations"] = actuations
    fleet = None
    if args.server:
        from lws_tpu_torch.core.metrics import parse_exposition

        req = urllib.request.Request(fleet_url, headers=_auth_headers())
        try:
            with urllib.request.urlopen(req, timeout=30,
                                        context=_url_context(fleet_url)) as resp:
                fleet = parse_exposition(resp.read().decode())
        except (urllib.error.URLError, ValueError) as e:
            print(f"warning: fleet metrics unavailable from {args.server}: {e}",
                  file=sys.stderr)
    if not args.prefill and target.engine.device.type == "cuda":
        print(engine_launch_line(target), file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(loadgen.render_report(report, fleet))
    return 0


def cmd_plan_steps(args) -> int:
    """≈ hack/plan-steps/main.go: print the DS rollout step table."""
    from lws_tpu_torch.controllers.disagg.planner import (
        ComputeAllSteps,
        RollingUpdateConfig,
        default_rolling_update_config,
    )

    initial = [int(x) for x in args.initial.split(",")]
    target = [int(x) for x in args.target.split(",")]
    if len(initial) != len(target):
        print("initial and target must have the same number of roles", file=sys.stderr)
        return 1
    config = default_rolling_update_config(len(initial))
    if args.surge:
        for i, s in enumerate(args.surge.split(",")):
            config[i] = RollingUpdateConfig(max_surge=int(s), max_unavailable=config[i].max_unavailable)
    if args.unavailable:
        for i, u in enumerate(args.unavailable.split(",")):
            config[i] = RollingUpdateConfig(max_surge=config[i].max_surge, max_unavailable=int(u))
    steps = ComputeAllSteps(initial, target, config)
    width = max(len(str(target)), len(str(initial)))
    print(f"{'step':>4}  {'old':>{width}}  {'new':>{width}}")
    for i, s in enumerate(steps):
        print(f"{i:>4}  {str(s.past):>{width}}  {str(s.new):>{width}}")
    return 0


def engine_launch_line(target) -> str:
    """An in-process target's kernel launches in this process, beside the
    engine's own counts they follow from (its depth, decode steps and,
    for the paged engine, prefix hits). On stderr, so the report on stdout
    stays what the JAX package's command prints."""
    from lws_tpu_torch.ops import launch_counts

    eng = target.engine
    facts = {"n_layers": eng.cfg.n_layers, **getattr(eng, "stats", {}),
             **getattr(eng, "stats_prefix", {})}
    return (f"# {target.kind} engine {json.dumps(facts)}; kernel launches "
            f"{json.dumps(launch_counts())}")


def main(argv=None) -> int:
    global _TLS_CONTEXT, _TOKEN
    p = argparse.ArgumentParser(prog="python -m lws_tpu_torch")
    p.add_argument("--cacert", default=None,
                   help="CA bundle to trust for https:// servers")
    p.add_argument("--insecure", action="store_true",
                   help="skip TLS verification for https:// servers")
    p.add_argument("--token", default=None,
                   help="Bearer token for an auth-enabled server (or set $LWS_TPU_TOKEN)")
    p.add_argument("--client-token-file", default=None,
                   help="read the Bearer token from this file (first token "
                        "of an install-rendered tokens.csv works)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="run the control plane + API server")
    sp.add_argument("--config", default=None)
    sp.add_argument("-f", "--filename", action="append")
    sp.add_argument("--port", type=int, default=9443)
    sp.add_argument("--state-file", default=None,
                    help="persist the object store here; restored on restart")
    sp.add_argument("--state-dir", default=None,
                    help="durable state directory (snapshot + write-ahead log; "
                         "every acknowledged write survives kill -9). Holds an "
                         "exclusive flock: run a second serve with --standby "
                         "for hot-spare HA")
    sp.add_argument("--standby", action="store_true",
                    help="with --state-dir: if another process holds the state "
                         "lock, wait for it to die instead of exiting, then "
                         "take over with zero lost acknowledged writes")
    sp.add_argument("--no-fsync", action="store_true",
                    help="with --state-dir: skip per-write fsync (faster, but "
                         "an OS crash may lose the tail of the journal)")
    sp.add_argument("--tls-dir", default=None,
                    help="serve HTTPS with an auto-generated, auto-rotated "
                         "self-signed cert kept in this directory")
    sp.add_argument("--token-file", default=None,
                    help="require Bearer-token auth on the API: CSV lines of "
                         "<token>,<name>,<role> (role: admin|view)")
    sp.set_defaults(fn=cmd_serve)

    ap = sub.add_parser("apply")
    ap.add_argument("-f", "--filename", required=True)
    ap.add_argument("--server", default="127.0.0.1:9443")
    ap.set_defaults(fn=cmd_apply)

    gp = sub.add_parser("get")
    gp.add_argument("kind")
    gp.add_argument("name", nargs="?")
    gp.add_argument("--namespace", "-n", default="default")
    gp.add_argument("--server", default="127.0.0.1:9443")
    gp.add_argument("-o", "--output", default="json")
    gp.set_defaults(fn=cmd_get)

    dp = sub.add_parser("delete")
    dp.add_argument("kind")
    dp.add_argument("namespace")
    dp.add_argument("name")
    dp.add_argument("--server", default="127.0.0.1:9443")
    dp.set_defaults(fn=cmd_delete)

    lp = sub.add_parser("logs", help="captured stdout/stderr of a pod's process")
    lp.add_argument("name")
    lp.add_argument("--namespace", "-n", default="default")
    lp.add_argument("--server", default="127.0.0.1:9443")
    lp.set_defaults(fn=cmd_logs)

    scp = sub.add_parser("scale")
    scp.add_argument("name")
    scp.add_argument("replicas", type=int)
    scp.add_argument("--namespace", "-n", default="default")
    scp.add_argument("--server", default="127.0.0.1:9443")
    scp.set_defaults(fn=cmd_scale)

    cp_ = sub.add_parser("cordon", help="mark a node unschedulable (or --uncordon)")
    cp_.add_argument("node")
    cp_.add_argument("--uncordon", action="store_true")
    cp_.add_argument("--server", default="127.0.0.1:9443")
    cp_.set_defaults(fn=cmd_cordon)

    dr = sub.add_parser("drain", help="cordon a node and evict its pods (groups recreate elsewhere)")
    dr.add_argument("node")
    dr.add_argument("--server", default="127.0.0.1:9443")
    dr.set_defaults(fn=cmd_drain)

    ip = sub.add_parser("install", help="render a deployable bundle: config, "
                        "TLS, API tokens, state dir, systemd unit, k8s manifests")
    ip.add_argument("dir")
    ip.add_argument("--port", type=int, default=None,
                    help="alias for --set port=N")
    ip.add_argument("--backend", default=None, choices=("local", "fake"),
                    help="alias for --set backend=NAME")
    ip.add_argument("--python", default=sys.executable)
    ip.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="override an install value (repeatable; "
                         "see lws_tpu_torch.cli.INSTALL_VALUES for the schema)")
    ip.add_argument("--values", default=None, metavar="FILE",
                    help="YAML file of install values (helm values.yaml analog)")
    ip.set_defaults(fn=cmd_install)

    pp = sub.add_parser("plan-steps", help="print a DisaggregatedSet rollout step table")
    pp.add_argument("--initial", required=True)
    pp.add_argument("--target", required=True)
    pp.add_argument("--surge", default="")
    pp.add_argument("--unavailable", default="")
    pp.set_defaults(fn=cmd_plan_steps)

    ep = sub.add_parser("events", help="controller decision trace (k8s Events)")
    ep.add_argument("name", nargs="?")
    ep.add_argument("--namespace", "-n", default=None)
    ep.add_argument("--server", default="127.0.0.1:9443")
    ep.set_defaults(fn=cmd_events)

    tp = sub.add_parser("top", help="live fleet view: SLO attainment, throughput, "
                        "in-flight depth, watchdog alerts (from /metrics/fleet)")
    tp.add_argument("--server", default="127.0.0.1:9443")
    tp.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds (rates need two frames)")
    tp.add_argument("--interval", type=float, default=2.0)
    tp.add_argument("--by-class", action="store_true", dest="by_class",
                    help="split class-labelled series into one row per "
                         "(instance, engine, class) — SLO/GOOD%% per "
                         "workload class")
    tp.add_argument("--top-k", type=int, default=40, dest="top_k",
                    help="instance rows to render, worst SLO first "
                         "(0 = unbounded)")
    tp.add_argument("--by-tier", action="store_true", dest="by_tier",
                    help="split PFX%% by cache tier: h%% (HBM resident), "
                         "H%% (host arena restore), R%% (remote sibling "
                         "fetch) — shares of all lookups, so h+H+R = PFX%%")
    tp.set_defaults(fn=cmd_top)

    mon = sub.add_parser("monitor", help="history-plane view: retained series "
                         "as sparklines, burn-rate columns, firing alerts, "
                         "the scale recommendation, and the last actuation "
                         "per plane (from /debug/history + /debug/decisions)")
    mon.add_argument("filter", nargs="?", default="",
                     help="only show series whose name{labels} contains this")
    mon.add_argument("--server", default="127.0.0.1:9443",
                     help="API server or worker telemetry host:port")
    mon.add_argument("--watch", action="store_true",
                     help="redraw every --interval seconds")
    mon.add_argument("--interval", type=float, default=2.0)
    mon.add_argument("--top", type=int, default=24,
                     help="series rows to render")
    mon.add_argument("--limit", type=int, default=512,
                     help="series to fetch from /debug/history")
    mon.add_argument("--top-k", type=int, default=40, dest="top_k",
                     help="burn-table rows to render, hottest first "
                          "(0 = unbounded)")
    mon.set_defaults(fn=cmd_monitor)

    ex = sub.add_parser("explain", help="request-journey forensics: one "
                        "request's cross-process waterfall + verdict "
                        "(from /debug/request/{id}), or the worst retained "
                        "journeys (--slowest/--breached/--errored)")
    ex.add_argument("request_id", nargs="?",
                    help="request id (the KV frame meta id) or a trace id "
                         "from an SLO exemplar")
    ex.add_argument("--server", default="127.0.0.1:9443",
                    help="API server (fleet-joined) or a worker telemetry "
                         "host:port (local leg only)")
    ex.add_argument("--slowest", action="store_true",
                    help="list the slowest retained journeys instead")
    ex.add_argument("--breached", action="store_true",
                    help="list SLO-breaching retained journeys instead")
    ex.add_argument("--errored", action="store_true",
                    help="list errored retained journeys instead")
    ex.add_argument("--klass", default="",
                    help="filter the index by workload class")
    ex.add_argument("--revision", default="",
                    help="filter the index by serving template revision "
                         "(the hash `lws-tpu rollout` shows)")
    ex.add_argument("--limit", type=int, default=10,
                    help="index rows to fetch")
    ex.add_argument("--json", action="store_true",
                    help="emit the raw journey/index JSON")
    ex.set_defaults(fn=cmd_explain)

    ro = sub.add_parser("rollout", help="rollout intelligence: the "
                        "control-plane transition timeline (/debug/rollout), "
                        "per-revision SLO comparison, canary verdicts, and "
                        "the last actuation per plane")
    ro.add_argument("--server", default="127.0.0.1:9443",
                    help="API server host:port")
    ro.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds")
    ro.add_argument("--interval", type=float, default=2.0)
    ro.add_argument("--limit", type=int, default=32,
                    help="timeline entries to fetch/render")
    ro.add_argument("--timeline-only", action="store_true",
                    dest="timeline_only",
                    help="skip the metrics fetch; ledger timeline only")
    ro.add_argument("--json", action="store_true",
                    help="emit the raw timeline/alerts/decisions JSON")
    ro.set_defaults(fn=cmd_rollout)

    wy = sub.add_parser("why", help="decision forensics: one actuation "
                        "decision's full evidence chain — burn window → "
                        "guards → verdict → actuation → convergence "
                        "(from /debug/decisions)")
    wy.add_argument("decision_id",
                    help="a decision id from the ACT lines / "
                         "/debug/decisions, or `last`, `last:scale`, "
                         "`last:rollout` for the most recent actuation")
    wy.add_argument("--server", default="127.0.0.1:9443",
                    help="API server or worker telemetry host:port")
    wy.add_argument("--limit", type=int, default=256,
                    help="decision records to fetch (the retained window)")
    wy.add_argument("--json", action="store_true",
                    help="emit the raw decision record JSON")
    wy.set_defaults(fn=cmd_why)

    prf = sub.add_parser("profile", help="continuous-profiling view: per-span "
                         "and top-of-stack self-time (from /debug/profile)")
    prf.add_argument("--server", default="127.0.0.1:9443")
    prf.add_argument("--fleet", action="store_true",
                     help="merge every ready worker's profile "
                          "(/debug/profile/fleet, instance-labelled)")
    prf.add_argument("--watch", action="store_true",
                     help="redraw every --interval seconds")
    prf.add_argument("--interval", type=float, default=2.0)
    prf.add_argument("--top", type=int, default=15,
                     help="rows per table")
    prf.add_argument("--limit", type=int, default=512,
                     help="heaviest collapsed stacks to fetch per instance")
    prf.add_argument("--collapsed", action="store_true",
                     help="print raw collapsed stacks (flamegraph.pl input) "
                          "instead of tables")
    prf.set_defaults(fn=cmd_profile)

    fp = sub.add_parser("faults", help="chaos controls: list/arm/disarm fault "
                        "schedules on a server's /debug/faults; --drain for "
                        "graceful worker drain")
    fp.add_argument("points", nargs="*", metavar="point=spec",
                    help="fault schedules to arm (docs/robustness.md grammar)")
    fp.add_argument("--server", default="127.0.0.1:9443",
                    help="API server or worker telemetry host:port")
    fp.add_argument("--clear", action="store_true",
                    help="disarm every fault point first")
    fp.add_argument("--drain", action="store_true",
                    help="POST /debug/drain instead (graceful worker drain)")
    fp.set_defaults(fn=cmd_faults)

    dv = sub.add_parser("devices", help="device-runtime view: fleet compile "
                        "ledger (which executables keep recompiling, and "
                        "their wall-clock cost) + per-pool HBM attribution "
                        "(from /debug/compile/fleet + the fleet exposition)")
    dv.add_argument("--server", default="127.0.0.1:9443",
                    help="API server (fleet fold) or a worker telemetry "
                         "host:port (single-instance ledger)")
    dv.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds")
    dv.add_argument("--interval", type=float, default=2.0)
    dv.add_argument("--limit", type=int, default=256,
                    help="ledger records to fetch per instance")
    dv.add_argument("--top", type=int, default=10,
                    help="rows per table to render (0 = unbounded)")
    dv.add_argument("--json", action="store_true",
                    help="dump the raw fleet fold instead of tables")
    dv.set_defaults(fn=cmd_devices)

    lg = sub.add_parser("loadgen", help="run a traffic scenario (seeded "
                        "open-loop arrivals + workload mix) against an "
                        "in-process engine or a live disagg pair; render "
                        "the per-class goodput report")
    lg.add_argument("scenario", nargs="?", help="built-in scenario name (see --list)")
    lg.add_argument("--spec", default=None, metavar="FILE",
                    help="JSON scenario spec file (overrides the name)")
    lg.add_argument("--seed", type=int, default=1234,
                    help="schedule seed: same seed -> byte-identical traffic")
    lg.add_argument("--target", default="paged", choices=("dense", "batch", "paged"),
                    help="in-process engine target (default paged)")
    lg.add_argument("--device", default=None,
                    help="device of the in-process target (default: the card; "
                         "cpu runs the plain PyTorch path)")
    lg.add_argument("--prefill", default=None, metavar="HOST:PORT",
                    help="prefill worker KV endpoint (with --decode: drive "
                         "a live disagg pair instead of an in-process engine)")
    lg.add_argument("--decode", default=None, metavar="HOST:PORT",
                    help="decode worker KV endpoint")
    lg.add_argument("--time-scale", type=float, default=1.0, dest="time_scale",
                    help="wall seconds per scenario second (2.0 = half speed)")
    lg.add_argument("--max-wall", type=float, default=120.0, dest="max_wall",
                    help="abort the drain after this many wall seconds "
                         "(unfinished requests report as incomplete)")
    lg.add_argument("--server", default=None,
                    help="API server to pull /metrics/fleet from for the "
                         "report's GOODPUT%%/PFX%%/SPEC%%/KV%% fleet block")
    lg.add_argument("--list", action="store_true", help="list built-in scenarios and exit")
    lg.add_argument("--json", action="store_true", help="emit the raw report dict as JSON")
    lg.set_defaults(fn=cmd_loadgen)

    args = p.parse_args(argv)
    if args.cacert or args.insecure:
        from lws_tpu_torch.core.certs import client_context

        _TLS_CONTEXT = client_context(args.cacert)
    if args.token:
        _TOKEN = args.token
    elif args.client_token_file:
        with open(args.client_token_file) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    _TOKEN = line.split(",")[0]
                    break
    elif os.environ.get("LWS_TPU_TOKEN"):
        _TOKEN = os.environ["LWS_TPU_TOKEN"]
    try:
        return args.fn(args)
    except BrokenPipeError:
        # Piped into head/less that exited: not an error.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
