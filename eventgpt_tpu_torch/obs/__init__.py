"""Telemetry of the port: the counterpart of ``eventgpt_tpu/obs``.

  * ``obs.metrics``   -- the process-global registry of counters, gauges and
    log2-bucket histograms, exposed as Prometheus text (``GET /metrics``),
    merged into ``/stats`` and written per train step to ``telemetry.jsonl``;
    the same names, help strings, buckets and label enums as the JAX
    package, so the same events render the same bytes.
  * ``obs.trace``     -- a ring of Chrome trace events: scheduler spans,
    request lifecycles, instants (``GET /trace``, ``--trace_out``).
  * ``obs.journey``   -- the per-request flight recorder and its phase
    decomposition (``GET /requests``, ``GET /request?rid=N``).
  * ``obs.memory``    -- the device-memory ledger, the static capacity
    model and the reconciliation against the allocator (``GET /memory``),
    which the admission headroom guard reads.
  * ``obs.series``    -- the sampled time-series store and the burn-rate
    alerts (``GET /series``, ``GET /alerts``).
  * ``obs.profiling`` -- ``torch.profiler`` ranges and the on-demand
    capture window (``POST /profile``, the trainer's ``--profile_dir``).

The rules of the JAX package hold: every module but ``profiling`` is
stdlib-only at import; disarmed, a probe costs one module-global check;
and instrumentation is chain-neutral -- it reads host clocks and host
values the scheduler already holds, never a device tensor (no ``.item()``,
no synchronize, no copy to the host), so chains are byte-identical armed
or disarmed.
"""
