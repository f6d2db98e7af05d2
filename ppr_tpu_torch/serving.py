"""Serve-time micro-batching scheduler — port of ``ppr_tpu/serving.py``.

The engine's cost a query falls as the batch grows (one sweep serves every
row of a dispatch), so a deployment coalesces concurrent queries into
device batches rather than dispatching them one by one; the reference has
no serving story at all (its only entry point is the sequential benchmark
loop, Gen_Util.java:146-165).

:class:`PPRBatchServer` wraps a :class:`~ppr_tpu_torch.service.PPRService`
with a single dispatcher thread (one card, one stream of work):

* ``submit(source, ...)`` returns a ``concurrent.futures.Future`` at once;
* the dispatcher drains whatever has queued, groups requests by their
  ``(k, eps)`` parameters, and runs one batched ``top_k`` per group;
* batches are padded up to a power-of-two bucket, so the engine sees
  O(log max_batch) widths, each a rung of the SLO policy's ladder with a
  service-time estimate of its own.

The dispatcher thread is not the thread that built the service. The
kernel wrappers launch on the card that holds their operands (they switch
to it when it is not current) and on the calling thread's current stream,
which in a thread that never set one is the card's default stream: the
dispatcher's kernels queue on the same stream as the rest of its work.

The scheduling policy is "drain, don't wait": while the device is busy with
batch t, every arrival queues and forms batch t+1. Under load the batch
size self-regulates toward throughput saturation (arrival rate x service
time), and an idle server dispatches a lone query immediately.
``max_delay_ms`` adds an optional accumulation window for
latency-tolerant, bursty clients; ``max_batch`` caps a dispatch (excess
stays queued).

``slo_ms`` replaces the static cap with a latency-targeted one: a
request's worst-case submit-to-result latency is about two dispatch
service times (wait for the in-flight batch, then ride the next), so the
scheduler walks the pow2 bucket ladder multiplicatively — jumping to the
fastest warm rung when ``2 * t(width) > slo_ms``, doubling the cap under
backlog only when the measured service time proves the next rung still
fits. The first dispatch at a new width is not a service-time sample: on
the card it pays the caching allocator's growth to that width's buffers,
and the first dispatch of a process also pays the once-per-process K0
probe (and, on a fresh checkout, the nvcc build of the kernels). The
update therefore ignores a width's first-ever sample and takes the second,
warm one.

When even the fastest observed width breaches the SLO — the target sits
below the service-time *intercept*, which no batch width can shrink — the
policy flips to best-effort mode (``stats.slo_unattainable``): grow under
backlog, and when the queue clears jump to the sampled rung with the
smallest warm service time, which on a backend whose service time falls
with width is the *widest* rung. These keep the ladder honest:

* :meth:`PPRBatchServer.prewarm` dispatches EVERY pow2 rung up to
  ``max_batch`` twice at startup and seeds each rung's estimate from the
  second, warm dispatch, so serving traffic never pays a first call and the
  policy ranks the full ladder from the first dispatch (``prewarm=True`` or
  the daemon's ``--prewarm``);
* for servers that skip prewarm, best-effort idle dispatches *explore*:
  while the warm trend is non-increasing in width, the cap climbs one
  unsampled rung instead of jumping, so wide rungs get sampled even when
  backlog never forms;
* downward idle jumps wait for ``idle_hysteresis`` consecutive
  no-backlog dispatches (a lone idle gap in a busy stream does not reset
  the ladder climb);
* ``stats.slo_unattainable`` tracks the CURRENT regime (it clears when a
  warm rung proves the SLO attainable again); ``slo_unattainable_ever``
  records whether best-effort mode was ever entered.

On an SLO breach the cap jumps to the fastest warm rung in one move
instead of halving: where service time does not rise with width, halving
moves latency the wrong way. Blind halving survives only as an idle-time
exploration fallback when the rung below has never been sampled, and is
refused under backlog, where shrinking pushes throughput below the offered
load by construction. Under sustained backlog the cap jumps to the rung
with the most rows a second, whatever its single-dispatch latency.

The policy (``_slo_update``, ``_choose_width``, ``_explore_width``),
``prewarm``, the dispatcher and :func:`serve_loop` are the JAX package's
code line for line; the tests feed both the same calls.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class ServerStats:
    requests: int = 0
    dispatches: int = 0
    dispatched_rows: int = 0
    padded_rows: int = 0
    batch_sizes: list = field(default_factory=list)
    latencies_ms: list = field(default_factory=list)
    #: (dispatch ordinal, new cap) every time the SLO policy moves the cap
    cap_moves: list = field(default_factory=list)
    #: True while the SLO policy's CURRENT warm samples show even the
    #: fastest width breaching the SLO (target below the service-time
    #: intercept) — best-effort mode. Clears if later samples prove the
    #: SLO attainable.
    slo_unattainable: bool = False
    #: latched: best-effort mode was entered at least once in this
    #: server's lifetime (the old latching semantics, kept for the record)
    slo_unattainable_ever: bool = False
    #: widths dispatched + EWMA-seeded by :meth:`PPRBatchServer.prewarm`
    prewarmed_widths: list = field(default_factory=list)
    #: rungs prewarm gave up on after a retry (left unwarmed, not fatal)
    prewarm_failed_widths: list = field(default_factory=list)
    #: dispatches padded past their pow2 bucket because a wider rung's
    #: warm EWMA was >=10% faster (service time falling with width)
    widened_dispatches: int = 0
    #: cap on retained per-request samples; a long-running daemon would
    #: otherwise grow without bound
    max_latency_samples: int = 1_000_000

    @property
    def mean_batch(self) -> float:
        return (self.dispatched_rows / self.dispatches) if self.dispatches else 0.0

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Submit-to-result latency percentiles over all completed requests.

        A retrieval engine's serving headline is latency as much as
        throughput; measured under load by ``serving_latency_torch.py``.
        """
        if not self.latencies_ms:
            return {f"p{q}": None for q in qs}
        xs = sorted(self.latencies_ms)
        out = {}
        for q in qs:
            # nearest-rank percentile: robust for the small-sample tails
            i = min(len(xs) - 1, max(0, int(round(q / 100.0 * len(xs))) - 1))
            out[f"p{q}"] = xs[i]
        return out


#: settle delay before a prewarm rung's single retry; module-level so
#: tests can shrink it
_PREWARM_RETRY_S = 60.0


def _pow2_bucket(b: int, lo: int = 8) -> int:
    n = lo
    while n < b:
        n <<= 1
    return n


def _ladder(lo: int, hi: int):
    """All pow2 rungs in [lo, hi]."""
    w = lo
    while w <= hi:
        yield w
        w <<= 1


class PPRBatchServer:
    """Micro-batching front end for
    :class:`~ppr_tpu_torch.service.PPRService`.

    >>> server = PPRBatchServer(svc, max_batch=1024)
    >>> fut = server.submit(41)           # returns immediately
    >>> hits = fut.result()               # list[TopKHit] for source 41
    """

    def __init__(self, service, *, max_batch: int = 1024,
                 max_delay_ms: float = 0.0, bucket: bool = True,
                 slo_ms: float | None = None, min_batch: int = 8,
                 adaptive_width: bool = True, prewarm: bool = False,
                 idle_hysteresis: int = 2, backlog_hysteresis: int = 3,
                 probe_source: int = 0, stale_after: int = 512):
        self._svc = service
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.bucket = bucket
        self.slo_ms = float(slo_ms) if slo_ms else None
        self.min_batch = int(min_batch)
        self.adaptive_width = bool(adaptive_width) and bucket
        #: consecutive no-backlog dispatches required before a *downward*
        #: idle cap move (a lone idle gap in a busy stream must not reset
        #: a ladder climb into an 8<->16 oscillation)
        self.idle_hysteresis = int(idle_hysteresis)
        #: consecutive backlogged dispatches before latency is treated as
        #: queue-dominated and the cap jumps to the max-rows/sec rung
        #: (see _slo_update)
        self.backlog_hysteresis = int(backlog_hysteresis)
        #: refresh horizon for per-width EWMAs (in dispatches): a rung not
        #: sampled for this long is re-probed rather than trusted forever
        self.stale_after = int(stale_after)
        # SLO policy state: current cap on the pow2 ladder, one warm
        # service-time EWMA per dispatched width (a width's first sample
        # pays its first call and is skipped — see module docstring), the
        # set of widths already seen once, the dispatch ordinal of each
        # rung's last sample, and the idle-streak counter.
        self._slo_cap = _pow2_bucket(self.min_batch)
        self._svc_time_ms: dict[int, float] = {}
        self._svc_time_at: dict[int, int] = {}
        self._seen_width: set[int] = set()
        self._idle_streak = 0
        self._backlog_streak = 0
        self._last_probe = -(1 << 30)
        self.stats = ServerStats()
        self._lock = threading.Condition()
        self._queue: list[
            tuple[int, int | None, float | None, Future, float]
        ] = []
        self._closed = False
        if prewarm:
            # before the dispatcher starts, so no service-call race
            self.prewarm(source=probe_source)
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="ppr-batch-dispatch", daemon=True
        )
        self._thread.start()

    def prewarm(self, source: int = 0, verbose: bool = True) -> None:
        """Dispatch every pow2 rung up to ``max_batch`` and seed its EWMA.

        Each rung is dispatched twice with a probe batch: the first pays
        the rung's first call (allocator growth to its buffers; at the
        first rung of a process also the K0 probe, and the kernels' build
        on a fresh checkout), the second's wall time seeds
        ``_svc_time_ms`` with a warm sample. After this no serving dispatch
        pays a first call, and the SLO policy's argmin ranks the FULL
        ladder from the first request: without it, a wide rung's only
        dispatches can be first calls, whose samples the EWMA skips,
        leaving the argmin blind to it.

        Called from ``__init__`` when ``prewarm=True`` (before the
        dispatcher thread starts, so the probe runs on this thread and no
        two threads race it); safe to call explicitly before serving
        traffic.
        """
        if getattr(self._svc, "supports_stream", False):
            # warm the cohort path (its per-row loop and the compaction
            # between stages, not the batch-global loop)
            def run(batch):
                self._svc.top_k_stream(batch, emit=lambda *a: None)
        else:
            def run(batch):
                self._svc.top_k(batch)

        # Spread probe sources over real nodes when the service exposes
        # its node count: W copies of one source would (a) measure only
        # that source's sweep train — the annealed batch runs until the
        # SLOWEST row settles, so a single easy source seeds an
        # unrepresentative EWMA — and (b) retire a cohort-streaming
        # dispatch in one stage, never exercising the ladder's
        # staggered-retirement path.
        n = int(getattr(self._svc, "n_nodes", 0) or 0)

        def probe_batch(width):
            if n > 1:
                return [(int(source) + i * 7919) % n for i in range(width)]
            return [int(source)] * width

        w = _pow2_bucket(self.min_batch)
        while w <= self.max_batch:
            batch = probe_batch(w)
            # Transient-failure tolerance: prewarm runs inside __init__, and
            # one failed dispatch during the ladder probe must not abort
            # server construction. Retry once after a settle delay; on
            # repeated failure skip the rung (it stays unwarmed; organic
            # traffic or _explore_width can still sample it later) and
            # record it.
            for attempt in (1, 2):
                try:
                    t0 = time.perf_counter()
                    run(batch)              # first call at this width
                    t_cold = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    run(batch)              # warm: true service time
                    t_warm = (time.perf_counter() - t0) * 1e3
                except Exception as e:  # noqa: BLE001 - transient backend
                    print(f"prewarm width {w} attempt {attempt} failed: "
                          f"{type(e).__name__}: {e}", file=sys.stderr,
                          flush=True)
                    if attempt == 1:
                        time.sleep(_PREWARM_RETRY_S)
                        continue
                    self.stats.prewarm_failed_widths.append(w)
                    break
                self._seen_width.add(w)
                self._svc_time_ms[w] = t_warm
                self._svc_time_at[w] = 0
                self.stats.prewarmed_widths.append(w)
                if verbose:
                    # stderr: stdout may be the daemon's JSON-lines channel
                    print(f"prewarm width {w}: cold {t_cold:.1f}s, "
                          f"warm {t_warm:.0f}ms", file=sys.stderr,
                          flush=True)
                break
            w <<= 1

    # ------------------------------------------------------------------ API
    def submit(self, source: int, k: int | None = None,
               eps: float | None = None) -> Future:
        """Enqueue one top-k query; resolves to a list of TopKHit."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self.stats.requests += 1
            self._queue.append((int(source), k, eps, fut, time.perf_counter()))
            self._lock.notify()
        return fut

    def top_k(self, source: int, k: int | None = None,
              eps: float | None = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(source, k, eps).result()

    def close(self) -> None:
        """Drain the queue, then stop the dispatcher."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- dispatcher
    def _cap(self) -> int:
        """Current dispatch cap: the static knob, or the SLO policy's rung."""
        if self.slo_ms is None:
            return self.max_batch
        return min(self.max_batch, self._slo_cap)

    def _take_batch(self):
        """Block until work (or close); return one (k, eps) -> requests dict."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if not self._queue:
                return None
            cap = self._cap()
            if self.max_delay_s > 0 and len(self._queue) < cap:
                # optional accumulation window for bursty clients
                self._lock.wait(timeout=self.max_delay_s)
            groups: dict[tuple, list] = defaultdict(list)
            rest = []
            for item in self._queue:
                key = (item[1], item[2])
                if len(groups[key]) < cap:
                    groups[key].append(item)
                else:
                    rest.append(item)
            self._queue = rest
            return groups, len(rest)

    def _note_service_time(self, width: int, service_ms: float):
        """Fold a timed dispatch into the per-width warm EWMA.

        Returns the updated EWMA, or None for a width's first-ever sample:
        that one pays the width's first call, not service time.
        (Unbucketed servers see a new width nearly every dispatch — there
        the skip would ignore nearly every sample, so don't.)
        """
        first = width not in self._seen_width
        self._seen_width.add(width)
        if first and self.bucket:
            return None
        prev = self._svc_time_ms.get(width, service_ms)
        t = 0.5 * prev + 0.5 * service_ms
        self._svc_time_ms[width] = t
        self._svc_time_at[width] = self.stats.dispatches
        return t

    def _choose_width(self, b: int) -> int:
        """Dispatch width for a ``b``-row batch: the pow2 bucket, widened
        to a strictly-faster sampled rung when the warm EWMAs prove one.

        Where service time falls with width (a narrow dispatch leaves the
        device idle while paying the same annealed sweep train), padding a
        16-row batch up to a wider rung is a pure latency win. The 10%
        margin keeps noise from flapping the width; every candidate rung
        has already run (it has a warm sample by construction).
        """
        width = min(_pow2_bucket(b), max(self.max_batch, 8))
        if not self.adaptive_width:
            return width
        explore = self._explore_width(width)
        if explore is not None:
            return explore
        t_cur = self._svc_time_ms.get(width)
        if t_cur is None:
            return width
        hi = max(self.max_batch, 8)
        cands = [w for w, tw in self._svc_time_ms.items()
                 if width < w <= hi and tw < 0.9 * t_cur]
        if not cands:
            # Staleness probe: a rung whose EWMA hasn't been refreshed in
            # `stale_after` dispatches may be carrying a transient outlier
            # (e.g. a retried dispatch) that silently disabled widening
            # forever. Re-dispatch at the stalest such rung, at most once
            # per 64 dispatches, so estimates decay toward reality instead
            # of freezing.
            now = self.stats.dispatches
            stale = [w for w, at in self._svc_time_at.items()
                     if width < w <= hi and now - at > self.stale_after]
            if stale and now - self._last_probe > 64:
                self._last_probe = now
                return min(stale, key=lambda w: self._svc_time_at[w])
            return width
        self.stats.widened_dispatches += 1
        return min(cands, key=self._svc_time_ms.get)

    def _explore_width(self, width: int) -> int | None:
        """Best-effort-mode ladder exploration: the next rung to pad a
        dispatch up to so it gains a warm sample.

        Under an unattainable SLO at light load, backlog never forms, so
        organic dispatches stay narrow and the fast wide rungs of a backend
        whose service time falls with width are never even run: the argmin
        would only ever see {8, 16}. While the warm trend is
        non-increasing in width (wider is not hurting), pad dispatches up
        the ladder one unwarmed rung at a time: the first dispatch at a
        rung pays its first call, the second leaves a warm EWMA, then the
        climb continues — 2*O(log max_batch) exploratory dispatches
        total, after which the argmin ranks the full ladder. A prewarmed
        server (``prewarm=True``) starts fully warm and never explores.
        """
        if self.slo_ms is None or not self.stats.slo_unattainable:
            return None
        warm = self._svc_time_ms
        if not warm:
            return None
        lo = _pow2_bucket(self.min_batch)
        hi = max(self.max_batch, lo)
        # Rising-trend stop on ADJACENT warmed rungs: comparing the top
        # rung against the global min would let one noisy top sample halt
        # exploration forever, and a burst-warmed high rung would hide the
        # unwarmed gap below it.
        ws = [w for w in _ladder(lo, hi) if w in warm]
        if len(ws) >= 2 and warm[ws[-1]] > 1.2 * warm[ws[-2]]:
            return None            # t clearly rising at the warm frontier
        for nxt in _ladder(lo, hi):
            if nxt >= width and nxt not in warm:
                return nxt
        return None

    def _slo_update(self, width: int, service_ms: float, backlog: bool):
        """Move the cap after a timed dispatch (SLO mode only).

        Worst-case request latency ~= 2 * t(width): wait out the in-flight
        dispatch, then ride the next. On breach, jump to the fastest warm
        rung in one move (see module docstring; blind halving only as an
        idle cold-start fallback when the rung below is unsampled);
        grow one rung under backlog when the *predicted* time at the next
        rung still fits (service time is affine in width with a positive
        intercept, so t(2w) <= 2*t(w) — doubling is safe iff 4*t(w) <= slo,
        or iff the next rung's own warm EWMA already fits).
        """
        t = self._note_service_time(width, service_ms)
        self._idle_streak = 0 if backlog else self._idle_streak + 1
        self._backlog_streak = self._backlog_streak + 1 if backlog else 0
        if t is None:
            return
        cap = self._slo_cap
        lo = _pow2_bucket(self.min_batch)
        hi = self.max_batch
        warm = self._svc_time_ms
        t_best = min(warm.values())
        # Current-regime flag: set while the fastest warm rung breaches
        # the SLO, cleared the moment a warm rung proves it attainable.
        # The `_ever` latch keeps the historical record.
        unattainable = 2.0 * t_best > self.slo_ms
        self.stats.slo_unattainable = unattainable
        if unattainable:
            # The target sits below the service-time intercept, so NO
            # width can meet it (t is affine in width). Pinning the cap at
            # min_batch would collapse capacity, and so would an argmin
            # that never saw a warm wide rung. Best-effort: maximize
            # throughput under backlog, sit on the warm-argmin rung when
            # idle (where t falls with width that is the widest rung),
            # and rely on prewarm/exploration (`_explore_width`) to make
            # the ladder actually warm.
            self.stats.slo_unattainable_ever = True
            if backlog and cap < hi:
                if all(w in warm for w in _ladder(lo, hi)):
                    # fully-warm ladder: jump straight to the best
                    # rows-per-second rung (every rung has run, the jump
                    # is free)
                    best = max(warm, key=lambda w: w / warm[w])
                    self._slo_cap = min(max(best, cap), hi)
                else:
                    self._slo_cap = cap * 2
            elif not backlog:
                # Latency-optimal rung: the warm argmin. Jumps UP are
                # immediate; jumps DOWN wait for `idle_hysteresis`
                # consecutive idle dispatches so a lone gap in a busy
                # stream cannot reset a ladder climb.
                best = min(warm, key=warm.get)
                new = min(max(best, lo), hi)
                if new > cap or self._idle_streak >= self.idle_hysteresis:
                    self._slo_cap = new
        elif backlog and self._backlog_streak >= self.backlog_hysteresis:
            # SUSTAINED backlog means request latency is queue-dominated
            # and the 2*t dispatch model undercounts it — any rung whose
            # rows/sec sits below the offered load only grows the queue,
            # however fast one dispatch looks (a latency-optimal narrow
            # rung can drain fewer rows a second than arrive). Serve the
            # queue at the max-throughput rung until it clears; the idle
            # logic then restores the latency-optimal rung. Never shrink
            # here.
            best = max((w for w in warm if lo <= w <= hi),
                       key=lambda w: w / warm[w], default=None)
            cap_t = warm.get(cap)
            cap_rps = (cap / cap_t) if cap_t else 0.0
            if best is not None and best != cap \
                    and best / warm[best] > 1.1 * cap_rps:
                # argmax rows/sec over warm rungs by definition never
                # reduces the drain rate, whichever direction it lies;
                # the 10% margin keeps noisy near-equal rungs from
                # ping-ponging the cap (which would starve the grow
                # probe below)
                self._slo_cap = min(max(best, lo), hi)
            elif cap < hi:
                # no clearly-better warm rung: probe one rung wider (the
                # queue pays one first call, which the EWMA skips) —
                # without this the sustained branch would pin the cap
                # inside the warmed prefix of the ladder forever
                self._slo_cap = cap * 2
        elif 2.0 * t > self.slo_ms:
            # Breach rule: one evidence-based jump to the fastest warm
            # rung, never a blind halving walk. Margin (10%) keeps two
            # near-equal rungs from flapping. Since t breaches but t_best
            # fits (the unattainable branch above owns the all-breach
            # case), the jump target meets the SLO. Under (transient)
            # backlog only THROUGHPUT-SAFE jumps (rows/sec at least the
            # current rung's) are allowed, and downward jumps when idle
            # wait out `idle_hysteresis` like the best-effort idle move —
            # both guards exist because the latency-optimal rung may be a
            # throughput trap (see the branch above).
            cands = {w: tw for w, tw in warm.items()
                     if lo <= w <= hi and tw < 0.9 * t}
            if backlog:
                cur_rps = width / max(t, 1e-9)
                cands = {w: tw for w, tw in cands.items()
                         if w / tw >= cur_rps}
            if cands:
                best = min(cands, key=cands.get)
                new = min(max(best, lo), hi)
                if new >= cap or backlog \
                        or self._idle_streak >= self.idle_hysteresis:
                    self._slo_cap = new
            elif cap > lo and (cap // 2) not in warm and not backlog:
                # cold-start fallback only: the rung below was never
                # sampled, so explore downward (classic-backend prior) —
                # never under backlog, where a shrink spirals.
                self._slo_cap = max(lo, cap // 2)
            # else: hold — the current rung is the best evidence we have
        elif backlog and cap < hi:
            up = warm.get(cap * 2)
            fits = (2.0 * up <= self.slo_ms) if up is not None \
                else (4.0 * t <= self.slo_ms)
            if fits:
                self._slo_cap = cap * 2
        if self._slo_cap != cap:
            self.stats.cap_moves.append((self.stats.dispatches, self._slo_cap))

    def _dispatch_loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            groups, n_rest = taken
            for (k, eps), items in groups.items():
                sources = [s for s, _, _, _, _ in items]
                futs = [f for _, _, _, f, _ in items]
                submits = [t for _, _, _, _, t in items]
                b = len(sources)
                width = b
                if self.bucket:
                    width = self._choose_width(b)
                    self.stats.padded_rows += width - b
                    sources = sources + [sources[0]] * (width - b)
                self.stats.dispatches += 1
                self.stats.dispatched_rows += b
                self.stats.batch_sizes.append(b)
                lat = self.stats.latencies_ms
                stream = getattr(self._svc, "supports_stream", False)
                t0 = time.perf_counter()
                try:
                    if stream:
                        # cohort streaming: a row's future resolves the
                        # moment ITS cohort retires — fast rows stop
                        # paying for the slowest row's sweep train
                        resolved = [False] * b

                        def emit(idxs, hits_rows, _r=resolved, _f=futs,
                                 _s=submits):
                            now = time.perf_counter()
                            for i, row in zip(idxs, hits_rows):
                                i = int(i)
                                if i < len(_f) and not _r[i]:
                                    _r[i] = True
                                    lat.append((now - _s[i]) * 1e3)
                                    _f[i].set_result(row)

                        self._svc.top_k_stream(sources, k=k, eps=eps,
                                               emit=emit)
                        for i, done_i in enumerate(resolved):
                            if not done_i:
                                futs[i].set_exception(RuntimeError(
                                    "cohort stream ended without this row"
                                ))
                    else:
                        rows = self._svc.top_k(sources, k=k, eps=eps)
                except Exception as e:  # noqa: BLE001 - fan the error out
                    for f in futs:
                        if not f.done():
                            f.set_exception(e)
                    continue
                done = time.perf_counter()
                if self.slo_ms is not None:
                    with self._lock:
                        backlog = n_rest > 0 or bool(self._queue)
                    self._slo_update(width, (done - t0) * 1e3, backlog)
                else:
                    # keep the per-width EWMAs warm for _choose_width
                    self._note_service_time(width, (done - t0) * 1e3)
                if not stream:
                    lat.extend((done - t) * 1e3 for t in submits)
                    for f, row in zip(futs, rows):
                        f.set_result(row)
                if len(lat) > self.stats.max_latency_samples:
                    del lat[: len(lat) - self.stats.max_latency_samples]


# ---------------------------------------------------------------- daemon
def serve_loop(service, in_stream, out_stream, **server_kwargs) -> ServerStats:
    """JSON-lines request/response loop over arbitrary streams.

    One request per line: ``{"source": int, "k"?: int, "eps"?: float,
    "id"?: any}``; response lines carry the request's ``id`` (default: the
    0-based request ordinal) and ``hits`` as ``[node, score, name]``
    triples, or ``error``. ``{"cmd": "stats"}`` reports scheduler counters.
    Responses stream back in completion order (the ``id`` correlates);
    pipelined requests coalesce into device batches via
    :class:`PPRBatchServer`. EOF drains and exits.
    """
    write_lock = threading.Lock()

    def emit(obj):
        with write_lock:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

    def on_done(req_id):
        def cb(fut: Future):
            err = fut.exception()
            if err is not None:
                emit({"id": req_id, "error": f"{type(err).__name__}: {err}"})
            else:
                emit({"id": req_id, "hits": [
                    [h.node, h.score, h.name] for h in fut.result()
                ]})
        return cb

    with PPRBatchServer(service, **server_kwargs) as server:
        pending = []
        for i, line in enumerate(in_stream):
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if req.get("cmd") == "stats":
                    emit({"id": req.get("id", i), "stats": {
                        "requests": server.stats.requests,
                        "dispatches": server.stats.dispatches,
                        "mean_batch": server.stats.mean_batch,
                        "padded_rows": server.stats.padded_rows,
                        "latency_ms": server.stats.latency_percentiles(),
                        "dispatch_cap": server._cap(),
                        "cap_moves": server.stats.cap_moves[-16:],
                        "slo_unattainable": server.stats.slo_unattainable,
                        "prewarmed_widths": server.stats.prewarmed_widths,
                        "widened_dispatches":
                            server.stats.widened_dispatches,
                    }})
                    continue
                fut = server.submit(
                    int(req["source"]), req.get("k"), req.get("eps")
                )
            except Exception as e:  # noqa: BLE001 - malformed request
                emit({"id": i, "error": f"{type(e).__name__}: {e}"})
                continue
            fut.add_done_callback(on_done(req.get("id", i)))
            pending.append(fut)
        for fut in pending:  # drain before close
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - already emitted as error line
                pass
    return server.stats


def main(argv=None) -> int:
    """``python -m ppr_tpu_torch.serving --db <dataset>`` — stdio PPR
    daemon, on the card unless ``--device cpu``."""
    import argparse

    from .cli import load_dataset
    from .graph.io import REFERENCE_GOT_DIR
    from .service import PPRService

    ap = argparse.ArgumentParser(
        prog="ppr_tpu_torch.serving",
        description="PPR top-k retrieval daemon (JSON lines on stdio)",
    )
    ap.add_argument("--db", default=REFERENCE_GOT_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the graph and the engine run (default cuda: "
                         "exits with an error when no card is visible)")
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--hub-split", type=int, default=None,
                    help="dense-hub hybrid SpMV hub count")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--early-exit", action="store_true",
                    help="annealed-loop top-k set-stability fast exit "
                         "(ids exact; values lower bounds)")
    ap.add_argument("--cohort", action="store_true",
                    help="per-row cohort streaming: a request's future "
                         "resolves when ITS row retires instead of when "
                         "the slowest row in the dispatch finishes")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure FORA's cost constants on the graph at "
                         "startup")
    ap.add_argument("--max-delay-ms", type=float, default=0.0)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="target worst-case request latency; replaces the "
                         "static --max-batch cap with an adaptive one "
                         "(grows under backlog while latency fits, shrinks "
                         "on breach)")
    ap.add_argument("--prewarm", action="store_true",
                    help="dispatch every pow2 width up to --max-batch "
                         "twice before serving: startup pays every first "
                         "call, and the SLO policy starts with the full "
                         "width ladder ranked")
    ap.add_argument("--mesh", default=None, metavar="DATAxGRAPH",
                    help="sharded engine on a device mesh (not ported: "
                         "raises)")
    ap.add_argument("--mesh-engine", default="edge",
                    choices=["edge", "node"],
                    help="mesh layout (with --mesh)")
    ap.add_argument("--frontier-blocks", type=int, default=None,
                    help="node-sharded ring only (with --mesh)")
    ap.add_argument("--precomputed", default=None, metavar="THRESHOLD[,K]",
                    help="serve from an existing BASE all-pair store "
                         "(pure precomputed reads, no device work)")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded engines are not ported yet (ROADMAP.md, "
            "queue 1, item 18)"
        )
    precomputed = None
    if args.precomputed:
        parts = args.precomputed.split(",")
        precomputed = (float(parts[0]),
                       int(parts[1]) if len(parts) > 1 else -1)
    ds = load_dataset(args.db, device=args.device)
    svc = PPRService.from_dataset(ds, alpha=args.alpha, eps=args.eps,
                                  k=args.k, hub_split=args.hub_split,
                                  calibrate=args.calibrate,
                                  precomputed=precomputed,
                                  early_exit=args.early_exit,
                                  cohort=args.cohort,
                                  mesh_engine=args.mesh_engine,
                                  frontier_blocks=args.frontier_blocks)
    print(json.dumps({"ready": True, "dataset": ds.name,
                      "n": ds.graph.n, "m": ds.graph.m,
                      "device": str(ds.graph.device)}),
          file=sys.stderr, flush=True)
    stats = serve_loop(svc, sys.stdin, sys.stdout,
                       max_batch=args.max_batch,
                       max_delay_ms=args.max_delay_ms,
                       slo_ms=args.slo_ms, prewarm=args.prewarm)
    print(json.dumps({"served": stats.requests,
                      "dispatches": stats.dispatches,
                      "mean_batch": round(stats.mean_batch, 2)}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
