"""Frontend fleet: a multi-process HTTP serving tier behaving as ONE frontend.

The reference architecture scales its ingress by running many stateless
HTTP frontends over one routed request plane (PAPER.md §1-2; DistServe and
Mooncake assume the same shape). One GIL-bound Python process tops out
around ~5.3k tok/s at 128 streams (BENCH_FRONTEND_r06), so this package
makes the frontend horizontally scalable while keeping the *semantics* of
a single process:

- :mod:`~dynamo_tpu_torch.fleet.supervisor` — spawns N frontend processes
  sharing one listen port (``SO_REUSEPORT``, inherited-listener fallback),
  restarts crashed children with jittered backoff, rolls SIGTERM drains
  one process at a time, and serves a fleet-level aggregation endpoint
  merging per-process ``/metrics`` + ``/debug/requests``.
- :mod:`~dynamo_tpu_torch.fleet.budget` — per-process admission gates lease
  slot *chunks* from a global inflight budget through the store; the
  store's atomic create-if-absent makes double-claims impossible and
  lease TTL returns a crashed process's budget.
- :mod:`~dynamo_tpu_torch.fleet.decisions` — store-backed, watch-mirrored
  KV-router decision cache so sticky routing survives a follow-up turn
  landing on a different frontend process.
"""

from __future__ import annotations


class FleetError(Exception):
    """Typed failure of the fleet control plane (DT005: supervisors and
    budget managers must raise something callers can route on)."""


def register_fleet_supervisor_metrics(registry) -> dict:
    """Supervisor-side series (one registry per supervisor process).
    Kept separate from the child set: a never-touched gauge renders as
    0, so registering e.g. ``fleet_workers_alive`` on every child would
    pollute aggregated queries with zeroed phantom series."""
    return {
        "workers_alive": registry.gauge(
            "fleet_workers_alive", "Fleet child processes currently running"
        ),
        "restarts": registry.counter(
            "fleet_restarts_total", "Fleet child restarts after unexpected exit"
        ),
        "scrape_errors": registry.counter(
            "fleet_scrape_errors_total",
            "Failed per-child scrapes during fleet aggregation",
        ),
    }


def register_fleet_child_metrics(registry) -> dict:
    """Child-side series (one registry per fleet frontend process)."""
    return {
        "budget_slots": registry.gauge(
            "fleet_budget_slots_held", "Admission slots this process holds"
        ),
        "budget_chunks": registry.gauge(
            "fleet_budget_chunks_held", "Budget chunks this process holds"
        ),
        "budget_claims": registry.counter(
            "fleet_budget_claims_total", "Budget chunk claim attempts by outcome"
        ),
        "decision_entries": registry.gauge(
            "fleet_decision_cache_entries", "Router decision-cache mirror size"
        ),
        "decision_hits": registry.counter(
            "fleet_decision_hits_total", "Router placements taken from the shared decision cache"
        ),
        "decision_writes": registry.counter(
            "fleet_decision_writes_total", "Router decisions published to the shared cache"
        ),
        "directory_entries": registry.gauge(
            "fleet_kv_directory_entries",
            "Block-residency entries in the global prefix directory "
            "mirror (summed over every published worker holdings map)",
        ),
        "transfer_choices": registry.counter(
            "fleet_kv_transfer_vs_recompute_total",
            "Routed placements with a non-trivial missing prefix, by "
            "economy outcome: choice=transfer (pull the run from a "
            "directory-listed holder) vs choice=recompute (prefill it "
            "locally)",
        ),
    }


def register_fleet_metrics(registry) -> dict:
    """The full fleet series set on one registry — the DT006 catalog
    guard's view (one definition, one help string, one type per name);
    real processes register only their own side."""
    return {
        **register_fleet_supervisor_metrics(registry),
        **register_fleet_child_metrics(registry),
    }
