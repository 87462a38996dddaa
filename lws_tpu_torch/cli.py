"""The port's command line: the control plane's commands and the `loadgen`
command of lws_tpu/cli.py, over the port's control plane and engines.

  python -m lws_tpu_torch serve  --config cfg.yaml [-f manifests.yaml ...] [--port N]
                                 [--state-file FILE]
  python -m lws_tpu_torch apply  -f manifests.yaml [--server HOST:PORT]
  python -m lws_tpu_torch get    KIND [NAME] [--server HOST:PORT] [-o yaml]
  python -m lws_tpu_torch delete KIND NAMESPACE NAME [--server HOST:PORT]
  python -m lws_tpu_torch scale  NAME REPLICAS [--server HOST:PORT]
  python -m lws_tpu_torch logs   POD [-n NAMESPACE] [--server HOST:PORT]
  python -m lws_tpu_torch events [NAME] [-n NAMESPACE] [--server HOST:PORT]
  python -m lws_tpu_torch loadgen --list
  python -m lws_tpu_torch loadgen SCENARIO [--seed N] [--target dense|batch|paged]
                                  [--device cpu] [--server HOST:PORT] [--json]
  python -m lws_tpu_torch loadgen SCENARIO --prefill HOST:PORT --decode HOST:PORT

The flags, the output and the exit codes are the JAX package's
(`lws-tpu serve|apply|get|delete|scale|logs|events|loadgen`), with the
global `--cacert`, `--insecure`, `--token`, `--client-token-file` and
`$LWS_TPU_TOKEN` for an https or auth-enabled `--server`. `serve` runs the
control plane and its API server in a process that never touches the card:
the pods it runs (`backend: local`) are the processes that do.

`serve`'s `--state-dir`, `--standby`, `--no-fsync`, `--tls-dir` and
`--token-file` wait for ROADMAP Queue 1 (c) (durability and HA) and fail
with an error naming it; `serve` does not start the continuous profiler,
whose `/debug/profile` route waits for item (a). The other commands of the
JAX package (`top`, `monitor`, `explain`, `rollout`, `why`, `profile`,
`devices`, `faults`: item (b); `cordon`, `drain`, `install`, `plan-steps`:
item (d)) are not ported yet.

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


# serve's flags that wait for a later slice, with the ROADMAP item each
# names when given.
_DEFERRED_SERVE_FLAGS = {
    "state_dir": "--state-dir",
    "standby": "--standby",
    "no_fsync": "--no-fsync",
    "tls_dir": "--tls-dir",
    "token_file": "--token-file",
}


def cmd_serve(args) -> int:
    from lws_tpu_torch.config import Configuration, load_configuration
    from lws_tpu_torch.core.serialize import load_store, save_store
    from lws_tpu_torch.manifest import load_manifests
    from lws_tpu_torch.runtime import ControlPlane
    from lws_tpu_torch.runtime.server import ApiServer

    for attr, flag in _DEFERRED_SERVE_FLAGS.items():
        if getattr(args, attr):
            raise SystemExit(
                f"error: {flag} is not ported yet: the write-ahead log, "
                "leader election, TLS and token auth wait for ROADMAP "
                "Queue 1 (c), durability and HA"
            )
    cfg = load_configuration(args.config) if args.config else Configuration()
    cp = ControlPlane(
        scheduler_provider=cfg.gang_scheduling_management.scheduler_provider,
        enable_scheduler=cfg.enable_scheduler,
        auto_ready=(cfg.backend == "fake"),
    )
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

    server = ApiServer(cp, port=args.port)
    dirty = {"flag": True}  # always persist once after boot
    if args.state_file:
        # Register BEFORE the manager threads start: the first burst of
        # post-restore reconcile writes must mark the state dirty too.
        cp.store.watch(lambda _ev: dirty.__setitem__("flag", True))
    server.start()
    cp.start()
    from lws_tpu_torch.version import user_agent

    print(f"{user_agent()} serving on http://127.0.0.1:{server.port} "
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


def cmd_scale(args) -> int:
    body = json.dumps({"replicas": args.replicas}).encode()
    print(json.dumps(_http(args.server, "POST", f"/scale/{args.namespace}/{args.name}", body)))
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
    deferred = "not ported yet (ROADMAP Queue 1 (c)): fails if given"
    sp.add_argument("--state-dir", default=None, help=deferred)
    sp.add_argument("--standby", action="store_true", help=deferred)
    sp.add_argument("--no-fsync", action="store_true", help=deferred)
    sp.add_argument("--tls-dir", default=None, help=deferred)
    sp.add_argument("--token-file", default=None, help=deferred)
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

    ep = sub.add_parser("events", help="controller decision trace (k8s Events)")
    ep.add_argument("name", nargs="?")
    ep.add_argument("--namespace", "-n", default=None)
    ep.add_argument("--server", default="127.0.0.1:9443")
    ep.set_defaults(fn=cmd_events)

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
