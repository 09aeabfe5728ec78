"""Always-on sampling profiler: thread stacks → stage-attributed
collapsed-stack flamegraphs.

A single process-wide daemon thread wakes ~``hz`` times a second
(default 50), snapshots every live thread's Python stack via
``sys._current_frames()``, and aggregates two views:

- **collapsed stacks** — ``root;frame;...;leaf  count`` lines (the
  Brendan Gregg flamegraph format), each stack rooted at its **stage
  bucket** so one glance shows where the CPU goes *per pipeline stage*;
- **stage counts** — samples bucketed into the existing stage taxonomy
  (``sync_stage_seconds`` stages, ``accel_stage_seconds`` stages, plus
  ``lock_wait`` / ``idle`` / ``other``) by frame matching: the
  innermost frame that matches a known (function, file) pair names the
  stage, a thread parked in ``TimedLock.acquire`` is ``lock_wait``, and
  a thread blocked in the stdlib's wait/select/accept plumbing is
  ``idle``. The counts feed the ``profile_stage_samples{stage}``
  instrument (process-global scope — co-located nodes share one
  interpreter and therefore one profiler).

Sampling is wait-free for the profiled threads — no locks are taken,
no code is instrumented; the only cost is the sampler thread's own
slice (measured alongside the obs kill switch in ``bench.py --obs``,
acceptance bound <2%). ``BABBLE_OBS=0`` or ``profile_hz=0`` keeps the
sampler off entirely.

On-demand windows (``GET /profile?seconds=N`` on the service) diff two
aggregate snapshots rather than starting anything; when no sampler is
running (killed, or a standalone tool), the capture spins a temporary
one for just that window. Output formats: ``collapsed`` (flamegraph
text), ``cprofile`` (a pstats-style self/cumulative table estimated
from the same samples), ``json``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import GLOBAL, enabled as obs_enabled

DEFAULT_HZ = 50.0
MAX_STACK_DEPTH = 48
MAX_STACKS = 8192  # distinct collapsed stacks kept; overflow aggregates

# -- stage taxonomy via frame matching --------------------------------------
# function name -> (path suffix, stage); innermost match wins. The
# suffixes pin common names ("commit", "acquire") to the module that
# gives them their stage meaning (docs/observability.md §Span stages).
_FRAME_TABLE: Dict[str, Tuple[str, str]] = {
    # sync stages
    "prepare_sync": ("node/core.py", "decode"),
    "_decode_chunk": ("node/core.py", "decode"),
    "_batch_prevalidate": ("node/core.py", "batch_verify"),
    "insert_event": ("hashgraph/hashgraph.py", "insert"),
    "insert_event_and_run_consensus": ("hashgraph/hashgraph.py", "insert"),
    "divide_rounds": ("hashgraph/hashgraph.py", "divide_rounds"),
    "decide_fame": ("hashgraph/hashgraph.py", "decide_fame"),
    "decide_round_received": ("hashgraph/hashgraph.py", "round_received"),
    "process_decided_rounds": ("hashgraph/hashgraph.py", "commit"),
    "commit": ("node/core.py", "proxy_deliver"),
    "add_self_event": ("node/core.py", "self_event"),
    "process_sig_pool": ("node/node.py", "process_sig_pool"),
    "_pull": ("node/node.py", "request_sync"),
    "_push": ("node/node.py", "eager_sync"),
    # accel stages (hashgraph/accel.py + ops/voting.py)
    "build_voting_window": ("ops/voting.py", "build"),
    "_build": ("hashgraph/accel.py", "build"),
    "_enqueue": ("hashgraph/accel.py", "dispatch"),
    "_launch": ("hashgraph/accel.py", "dispatch"),
    "launch_sweep": ("ops/voting.py", "dispatch"),
    "read_sweep": ("ops/voting.py", "readback"),
    "_apply": ("hashgraph/accel.py", "apply"),
    "apply_fame": ("ops/voting.py", "apply"),
    "apply_round_received": ("ops/voting.py", "apply"),
    # lock wait: the instrumented core lock only — a thread inside
    # TimedLock.acquire is by definition waiting on the core lock
    "acquire": ("common/timed_lock.py", "lock_wait"),
}

# Innermost-frame (function, stdlib file) pairs that mean the thread is
# parked, not working. Matched by basename — stdlib paths vary.
_IDLE_FUNCS = frozenset(
    (
        "wait", "_wait_for_tstate_lock", "get", "put", "select", "poll",
        "accept", "recv", "recv_into", "readinto", "sleep", "read",
        "readline", "flush", "settimeout", "join", "epoll",
    )
)
_IDLE_FILES = frozenset(
    ("threading.py", "queue.py", "selectors.py", "socket.py", "ssl.py",
     "socketserver.py", "connection.py", "subprocess.py")
)


def frame_meta(fn: str, fname: str) -> Tuple[Optional[str], bool]:
    """(matched stage or None, marks-idle-when-innermost) for one
    frame — the single classification rule the sampler caches per code
    object. ``sleep`` covers Python sleep wrappers (common/clock.py),
    and this module's own frames mark idle because a thread parked in
    C-level ``time.sleep`` shows its Python caller as innermost."""
    path = fname.replace("\\", "/")
    stage = None
    hit = _FRAME_TABLE.get(fn)
    if hit is not None and (not hit[0] or path.endswith(hit[0])):
        stage = hit[1]
    idle = (
        (fn in _IDLE_FUNCS and os.path.basename(fname) in _IDLE_FILES)
        or fn == "sleep"
        or path.endswith("obs/profile.py")
    )
    return stage, idle


def stack_bucket(metas) -> str:
    """Stage bucket for one stack from per-frame ``(stage, idle)``
    pairs, innermost first: idle counts only at the innermost frame,
    then the first stage match walking outward, else ``other``. THE
    classification walk — classify() and the sampler hot path both run
    this, so the tested rule cannot diverge from the shipped one."""
    for depth, (stage, idle) in enumerate(metas):
        if depth == 0 and idle:
            return "idle"
        if stage is not None:
            return stage
    return "other"


def classify(frames: List[Tuple[str, str]]) -> str:
    """Stage bucket for one ``(function, filename)`` stack (innermost
    first) — the uncached reference path over the same rule."""
    return stack_bucket(frame_meta(fn, fname) for fn, fname in frames)


def _frame_label(fn: str, fname: str) -> str:
    base = os.path.basename(fname)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}:{fn}"


class StackSampler:
    """The process-wide sampler. Aggregates are written by the sampler
    thread only and read by copy (GIL atomicity), so the hot path of
    every *profiled* thread pays nothing.

    Tick cost is kept low by caching per-code-object metadata (label,
    matched stage, idle-ness) the first time a frame is seen and
    aggregating stacks as tuples of interned labels — string rendering
    happens lazily at snapshot time, never on the sampling path."""

    def __init__(self, hz: float = DEFAULT_HZ):
        self.hz = max(1.0, min(float(hz), 1000.0))
        self.period_s = 1.0 / self.hz
        self.samples_total = 0  # one per thread per tick
        self.ticks = 0
        self.started_at: Optional[float] = None
        self.stage_counts: Dict[str, int] = {}
        # (stage, tuple-of-labels root→leaf) -> count
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        # code object -> (label, stage-or-None, is_idle_innermost)
        self._code_meta: Dict[object, Tuple[str, Optional[str], bool]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self.started_at = time.time()
        t = threading.Thread(
            target=self._loop, name="obs-profiler", daemon=True
        )
        t.start()
        self._thread = t

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=1.0)
        self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period_s):
            try:
                self.sample_once(skip_ident=me)
            except Exception:
                # the profiler must never take the process down
                pass

    # -- sampling ------------------------------------------------------------

    def _meta(self, code) -> Tuple[str, Optional[str], bool]:
        """Cached per-code metadata: collapsed-stack label, the stage
        this frame matches (if any), and whether it marks the thread
        idle when innermost. One classify() cost per unique code object
        per process lifetime."""
        m = self._code_meta.get(code)
        if m is None:
            fn, fname = code.co_name, code.co_filename
            stage, idle = frame_meta(fn, fname)
            m = (sys.intern(_frame_label(fn, fname)), stage, idle)
            self._code_meta[code] = m
        return m

    def sample_once(self, skip_ident: Optional[int] = None) -> None:
        """One tick: every live thread's stack into the aggregates.
        Public for tests and for sim harnesses that want deterministic
        tick counts."""
        self.ticks += 1
        meta = self._meta
        for ident, frame in sys._current_frames().items():
            if ident == skip_ident:
                continue
            labels: List[str] = []
            metas: List[Tuple[Optional[str], bool]] = []
            f = frame
            depth = 0
            while f is not None and depth < MAX_STACK_DEPTH:
                label, frame_stage, frame_idle = meta(f.f_code)
                labels.append(label)
                metas.append((frame_stage, frame_idle))
                f = f.f_back
                depth += 1
            stage = stack_bucket(metas)
            self.samples_total += 1
            self.stage_counts[stage] = self.stage_counts.get(stage, 0) + 1
            labels.reverse()
            key = (stage, tuple(labels))
            if key in self._stacks:
                self._stacks[key] += 1
            elif len(self._stacks) < MAX_STACKS:
                self._stacks[key] = 1
            else:
                k = ("other", ("(stack-table-full)",))
                self._stacks[k] = self._stacks.get(k, 0) + 1

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        # list(...) first: the items copy is one C-level op the GIL
        # makes atomic, where a Python-level comprehension over the
        # live dict would race the sampler thread's inserts ("dict
        # changed size during iteration"). Collapsed keys are rendered
        # from the copy — never on the sampling path.
        items = list(self._stacks.items())
        stacks = {
            f"stage:{stage};" + ";".join(labels): count
            for (stage, labels), count in items
        }
        return {
            "hz": self.hz,
            "samples": self.samples_total,
            "ticks": self.ticks,
            "stages": dict(self.stage_counts),
            "stacks": stacks,
        }


def _diff_counts(after: Dict[str, int],
                 before: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d > 0:
            out[k] = d
    return out


def collapsed_text(stacks: Dict[str, int]) -> str:
    """Flamegraph collapsed-stack format, biggest first."""
    lines = [
        f"{key} {count}"
        for key, count in sorted(
            stacks.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def cprofile_text(stacks: Dict[str, int], period_s: float,
                  limit: int = 40) -> str:
    """pstats-style table ESTIMATED from samples: self/cumulative
    sample counts converted to seconds at the sampling period. The
    header says so — these are statistical times, not cProfile's
    deterministic ones, but the columns read the same way."""
    self_c: Dict[str, int] = {}
    cum_c: Dict[str, int] = {}
    total = 0
    for key, count in stacks.items():
        frames = key.split(";")
        total += count
        if not frames:
            continue
        leaf = frames[-1]
        self_c[leaf] = self_c.get(leaf, 0) + count
        for fr in set(frames):
            cum_c[fr] = cum_c.get(fr, 0) + count
    hdr = (
        f"sampled profile: {total} samples at {1.0 / period_s:.0f} Hz "
        f"(period {1e3 * period_s:.1f} ms); times are samples x period\n"
        f"{'samples':>9} {'self_s':>8} {'self%':>6} {'cum_s':>8} "
        f"{'cum%':>6}  function\n"
    )
    rows = []
    for fr, n in sorted(self_c.items(), key=lambda kv: -kv[1])[:limit]:
        cn = cum_c.get(fr, n)
        rows.append(
            f"{n:>9} {n * period_s:>8.3f} "
            f"{(100.0 * n / total if total else 0):>6.1f} "
            f"{cn * period_s:>8.3f} "
            f"{(100.0 * cn / total if total else 0):>6.1f}  {fr}"
        )
    return hdr + "\n".join(rows) + ("\n" if rows else "")


# -- process-wide singleton --------------------------------------------------

_sampler: Optional[StackSampler] = None
_lock = threading.Lock()


def stage_counts() -> Dict[str, int]:
    """Live per-stage sample counts, empty when no sampler runs — the
    reader behind the profile_stage_samples{stage} instrument
    (registered by metrics.wire_global so the catalog contract holds
    whether or not the profiler ever started)."""
    s = _sampler
    return dict(s.stage_counts) if s is not None else {}


def resolve_hz(hz: Optional[float] = None) -> float:
    """Config value unless the env overrides (whole-cluster toggles
    without touching every node's flags): BABBLE_PROFILE_HZ."""
    env = os.environ.get("BABBLE_PROFILE_HZ")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return DEFAULT_HZ if hz is None else float(hz)


def ensure_started(hz: Optional[float] = None) -> Optional[StackSampler]:
    """Start (or return) the process sampler. None when profiling is
    off (BABBLE_OBS=0 kill switch, or resolved hz <= 0)."""
    global _sampler
    if not obs_enabled():
        return None
    hz = resolve_hz(hz)
    if hz <= 0:
        return None
    with _lock:
        if _sampler is None or not _sampler.running():
            _sampler = StackSampler(hz=hz)
            _sampler.start()
        return _sampler


def sampler() -> Optional[StackSampler]:
    return _sampler


def stop() -> None:
    """Test hook: stop and forget the process sampler."""
    global _sampler
    with _lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def capture(seconds: float = 3.0,
            hz: Optional[float] = None) -> Dict[str, object]:
    """One profiling window: diff the running sampler's aggregates
    across ``seconds`` (or run a temporary sampler for just the window
    when none is running and the kill switch allows one).

    Returns ``{seconds, hz, samples, stages, stacks}`` — raw dicts;
    render with :func:`collapsed_text` / :func:`cprofile_text`."""
    seconds = max(0.05, min(float(seconds), 60.0))
    s = _sampler if _sampler is not None and _sampler.running() else None
    temp = None
    if s is None:
        if not obs_enabled():
            return {"error": "profiler disabled (BABBLE_OBS=0)"}
        temp = StackSampler(hz=resolve_hz(hz))
        temp.start()
        s = temp
    before = s.snapshot()
    time.sleep(seconds)
    after = s.snapshot()
    if temp is not None:
        temp.stop()
    return {
        "seconds": seconds,
        "hz": s.hz,
        "always_on": temp is None,
        "samples": after["samples"] - before["samples"],
        "stages": _diff_counts(after["stages"], before["stages"]),
        "stacks": _diff_counts(after["stacks"], before["stacks"]),
    }
