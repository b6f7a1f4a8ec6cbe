"""repro_torch.obs — unified telemetry plane (metrics, tracing, export).

The port's copy of ``repro.obs`` (stdlib only), with the reference's
metric names, span names and categories.

One import point for the whole surface:

    from repro_torch.obs import MetricsRegistry, Tracer, render_prometheus

Metric families (all ``repro_``-prefixed; full table in README
"Observability"):

  * step pipeline   — ``repro_steps_total``, ``repro_step_wall_ms``,
    ``repro_segment_step_ms``, ``repro_tasks_live``, ``repro_tasks_paused``,
    ``repro_cost_cores``
  * transport       — ``repro_transport_publishes``,
    ``repro_transport_bytes_published``, ``repro_transport_fetches``
  * workers         — ``repro_worker_rpcs_total{op=}``,
    ``repro_worker_respawns_total``
  * compile cache   — ``repro_compile_cache_{hits,misses,evictions,entries}``
  * checkpointing   — ``repro_checkpoints_total``, ``repro_checkpoint_save_ms``
  * reuse savings   — ``repro_reuse_tasks_saved``,
    ``repro_reuse_tasks_{submitted,reused}_total``,
    ``repro_reuse_core_steps_avoided_total``, ``repro_merge_events_total``,
    ``repro_unmerge_events_total``, ``repro_fusion_segments_saved_total``,
    ``repro_serve_slots_saved{tenant=}``

Everything here is stdlib-only and JAX-free — the dry-run coordinator and
the serving front end import it unconditionally.
"""
from .metrics import (
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    NullRegistry,
    merge_snapshots,
    parse_prometheus,
    process_metrics,
    render_prometheus,
)
from .tracing import Tracer, chrome_trace_json, process_tracer, write_chrome_trace

__all__ = [
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NullRegistry",
    "Tracer",
    "chrome_trace_json",
    "merge_snapshots",
    "parse_prometheus",
    "process_metrics",
    "process_tracer",
    "render_prometheus",
    "write_chrome_trace",
]
