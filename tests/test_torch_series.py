"""The port's time-series store and burn-rate alerts against the JAX
package's ``SeriesStore``, on an injected clock.

Both registries are zeroed, then driven through the same seeded timeline
(queue depth, SLO finishes met and missed, miss causes, breaker flips,
ledger bytes, TTFT and latency observations, arrivals); both stores sample
at the same instants (``sample_once(now=...)``, no sleeps). Every sample,
the snapshot and the alert state equal the JAX store's, and every rule of
``ALERT_RULES`` fires and clears along the way. The module-level probes
answer as the JAX ones, disarmed and armed.
"""

import numpy as np
import pytest

from eventgpt_tpu.obs import metrics as jmetrics
from eventgpt_tpu.obs import series as jseries
from eventgpt_tpu_torch.obs import metrics as tmetrics
from eventgpt_tpu_torch.obs import series as tseries

CAPACITY = 1000.0


@pytest.fixture
def registries():
    prev = (tmetrics.REGISTRY.enabled, jmetrics.REGISTRY.enabled)
    for mod in (tmetrics, jmetrics):
        mod.configure(True)
        mod.REGISTRY.reset()
    yield
    tmetrics.configure(prev[0])
    jmetrics.configure(prev[1])
    for mod in (tmetrics, jmetrics):
        mod.REGISTRY.reset()


def _apply(mod, store, t, rng_state):
    """One tick of the scripted timeline on ``mod``'s registry."""
    rng = np.random.default_rng(rng_state)
    m = mod
    phase = t // 12
    depth = (2 + t % 3) if phase % 2 == 0 else 10 + 2 * (t % 12)
    m.SERVE_QUEUE_DEPTH.set(depth)
    m.SERVE_ACTIVE_ROWS.set(int(rng.integers(0, 4)))
    if phase == 1 and t % 2:
        m.SERVE_BREAKER_OPEN.set(float(t % 4 == 1))
    miss = phase in (1, 3)
    for _ in range(3):
        met = not miss or rng.random() < 0.2
        m.SERVE_SLO_REQUESTS.inc(slo_class="interactive", met="true" if met else "false")
        if not met:
            cause = "queue" if phase == 1 else "decode"
            m.SERVE_SLO_MISS_CAUSE.inc(slo_class="interactive", cause=cause)
        m.SERVE_REQUESTS.inc(status="ok")
        m.SERVE_TTFT.observe(float(rng.exponential(0.05 if not miss else 0.8)))
        m.SERVE_LATENCY.observe(float(rng.exponential(1.0)))
    m.SERVE_TOKENS.inc(int(rng.integers(5, 40)))
    m.SERVE_SLO_GOODPUT.set(0.5 if miss else 1.0)
    m.MEM_TOTAL.set(CAPACITY * (0.5 + 0.02 * t if phase == 2 else 0.5))
    store.note_submit(int(rng.integers(1, 5)))


def test_the_same_samples_give_the_same_series_and_alerts(registries):
    kw = dict(interval_s=1.0, keep=32, queue_min=8.0, cause_min_misses=2, flap_min=3,
              mem_capacity_bytes=CAPACITY, arm_samples=2, clear_samples=3)
    stores = {"torch": tseries.SeriesStore(**kw), "jax": jseries.SeriesStore(**kw)}
    mods = {"torch": tmetrics, "jax": jmetrics}
    fired = set()
    for t in range(60):
        now = 100.0 + t
        for name, store in stores.items():
            _apply(mods[name], store, t, 7 * t + 1)
        samples = {name: store.sample_once(now=now) for name, store in stores.items()}
        assert samples["torch"] == samples["jax"], t
        snaps = {n: s.snapshot(window_s=8.0, n=16, now=now) for n, s in stores.items()}
        assert snaps["torch"] == snaps["jax"], t
        alerts = {n: s.alerts_snapshot(now=now) for n, s in stores.items()}
        assert alerts["torch"] == alerts["jax"], t
        fired |= set(alerts["torch"]["active"])
    assert fired == set(tseries.ALERT_RULES) == set(jseries.ALERT_RULES)
    assert stores["torch"].stats() == stores["jax"].stats()
    final = stores["torch"].alerts_snapshot(now=200.0)
    assert all(final["rules"][r]["transitions"] >= 1 for r in tseries.ALERT_RULES)
    assert tmetrics.ALERT_TRANSITIONS.labeled() == jmetrics.ALERT_TRANSITIONS.labeled()
    assert tmetrics.ALERT_ACTIVE.labeled() == jmetrics.ALERT_ACTIVE.labeled()


def test_the_module_probes_answer_as_jax(registries):
    prev = (tseries.active(), jseries.active())
    try:
        for mod in (tseries, jseries):
            mod.disable()
        assert tseries.snapshot() == jseries.snapshot() == {"enabled": False}
        assert tseries.alert_stats() == jseries.alert_stats()
        for mod in (tseries, jseries):
            mod.configure(interval_s=1.0, keep=8, autostart=False)
            mod.note_submit(3)
        assert tseries.active().stats() == jseries.active().stats()
        assert tseries.alert_stats() == jseries.alert_stats()
        assert tmetrics.ALERT_ACTIVE.labeled() == jmetrics.ALERT_ACTIVE.labeled()
        assert tseries.configure(interval_s=0) is None and not tseries.enabled()
    finally:
        for mod, store in zip((tseries, jseries), prev):
            mod.disable()
            mod._store = store
