"""Component configuration (≈ api/config/v1alpha1 + pkg/config).

A versioned config file (YAML) is strict-decoded, defaulted, validated, and
mapped onto ControlPlane options — the same load->default->validate->apply
pipeline as the reference (pkg/config/config.go, cmd/main.go:264-360).

The port's copy of lws_tpu/config.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

API_VERSION = "config.lws.tpu/v1alpha1"
KIND = "Configuration"

KNOWN_SCHEDULER_PROVIDERS = ("gang",)


@dataclass
class HealthConfig:
    port: int = 8081


@dataclass
class MetricsConfig:
    port: int = 8443


@dataclass
class ApiConfig:
    port: int = 9443


@dataclass
class GangSchedulingManagement:
    # ≈ api/config/v1alpha1/configuration_types.go:141
    scheduler_provider: Optional[str] = None


@dataclass
class Configuration:
    api: ApiConfig = field(default_factory=ApiConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    gang_scheduling_management: GangSchedulingManagement = field(
        default_factory=GangSchedulingManagement
    )
    enable_scheduler: bool = True
    # Backend that runs pods: "fake" (status driven externally/tests) or
    # "local" (spawn local processes wired by the env contract).
    backend: str = "local"
    # ≈ client QPS/burst defaults (defaults.go:35-36); advisory here since the
    # store is in-process, kept for config-surface parity.
    client_qps: int = 500
    client_burst: int = 500


def default_configuration(cfg: Configuration) -> Configuration:
    """≈ SetDefaults_Configuration (defaults.go:42-97)."""
    if cfg.api.port <= 0:
        cfg.api.port = 9443
    if cfg.health.port <= 0:
        cfg.health.port = 8081
    if cfg.metrics.port <= 0:
        cfg.metrics.port = 8443
    if cfg.client_qps <= 0:
        cfg.client_qps = 500
    if cfg.client_burst <= 0:
        cfg.client_burst = 500
    return cfg


def validate_configuration(cfg: Configuration) -> None:
    """≈ pkg/config/validation.go:36-60."""
    sp = cfg.gang_scheduling_management.scheduler_provider
    if sp is not None and sp not in KNOWN_SCHEDULER_PROVIDERS:
        raise ValueError(
            f"unknown schedulerProvider {sp!r}; known: {list(KNOWN_SCHEDULER_PROVIDERS)}"
        )
    if cfg.backend not in ("fake", "local"):
        raise ValueError(f"unknown backend {cfg.backend!r}; known: ['fake', 'local']")
    ports = [cfg.api.port, cfg.health.port, cfg.metrics.port]
    if len(set(ports)) != len(ports):
        raise ValueError(f"api/health/metrics ports must be distinct, got {ports}")


def load_configuration(path: str) -> Configuration:
    """Strict decode: unknown fields are errors (the reference uses strict
    component-config decoding for the same reason — typos must not silently
    change behavior)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if raw.get("apiVersion", API_VERSION) != API_VERSION:
        raise ValueError(f"unsupported apiVersion {raw.get('apiVersion')!r}")
    if raw.get("kind", KIND) != KIND:
        raise ValueError(f"unsupported kind {raw.get('kind')!r}")

    cfg = Configuration()
    consumed = {"apiVersion", "kind"}

    def take(key, target, attr, cast=lambda x: x):
        if key in raw:
            setattr(target, attr, cast(raw[key]))
        consumed.add(key)

    def section(key: str, allowed: set[str]) -> dict:
        data = raw.get(key, {}) or {}
        bad = set(data) - allowed
        if bad:
            raise ValueError(f"unknown configuration fields in {key}: {sorted(bad)}")
        return data

    cfg.api.port = int(section("api", {"port"}).get("port", cfg.api.port))
    cfg.health.port = int(section("health", {"port"}).get("port", cfg.health.port))
    cfg.metrics.port = int(section("metrics", {"port"}).get("port", cfg.metrics.port))
    gsm = section("gangSchedulingManagement", {"schedulerProvider"})
    if gsm:
        cfg.gang_scheduling_management.scheduler_provider = gsm.get("schedulerProvider")
    take("enableScheduler", cfg, "enable_scheduler", bool)
    take("backend", cfg, "backend", str)
    take("clientQPS", cfg, "client_qps", int)
    take("clientBurst", cfg, "client_burst", int)
    consumed |= {"api", "health", "metrics", "gangSchedulingManagement"}

    unknown = set(raw) - consumed
    if unknown:
        raise ValueError(f"unknown configuration fields: {sorted(unknown)}")

    cfg = default_configuration(cfg)
    validate_configuration(cfg)
    return cfg
