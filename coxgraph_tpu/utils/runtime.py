"""Runtime setup helpers: compilation cache, platform forcing, timing.

The observability counterpart of the reference's voxblox timing::Timer +
node_evaluator hooks (SURVEY.md §5.1).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO, ".jax_cache")


def enable_compilation_cache() -> str:
    """Persist XLA compilations across processes → the cache directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and JAX reads it
    itself; otherwise the cache is the fixed, git-ignored
    ``<repo>/.jax_cache`` (a fixed path, because the path is part of the
    cache key).

    Every program is persisted, not only those past JAX's 1 s default
    compile time: a warm ``bench.py --no-solve`` process on an H100
    (400 W) took 12.2 s with this threshold against 19.0 s with the
    default, and the cold runs did not get slower (144 s vs 165 s)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def force_cpu(n_devices: int = 8) -> None:
    """Force the CPU backend with ``n_devices`` virtual devices. Must run
    before any computation."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    jax.config.update("jax_platforms", "cpu")


def require_gpu():
    """The first GPU device, or SystemExit(2) when JAX finds none: device
    measurements never fall back to the CPU."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        raise SystemExit(
            f"no GPU: JAX backend is {jax.default_backend()!r}; this "
            "command measures the GPU and has no CPU fallback")
    return devs[0]


def gpu_card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card — the
    card and power limit every device number is reported beside."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: no output"


class Timers:
    """Aggregating scoped wall-clock timers (device-synchronizing), after
    voxblox timing::Timer / timing::Timing::Print (tsdf_recover.h:63-93)."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def report(self) -> str:
        lines = ["timers:"]
        for k in sorted(self.total):
            n = self.count[k]
            tot = self.total[k]
            lines.append(
                f"  {k:32s} n={n:6d} total={tot:8.3f}s mean={tot / n * 1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"n": self.count[k], "total_s": self.total[k]}
             for k in self.total}
        )


class ResourceSampler:
    """Process CPU/memory sampling — the node_evaluator equivalent
    (reference: per-node ["cpu","mem"] eval modes,
    evaluation_config.yaml:1-2). Reads /proc; sample() returns deltas
    since the previous call. start(rate_hz)/stop() run the periodic
    sampling loop the reference's node_evaluator runs per node;
    summary() is the end-of-experiment rollup (its plot_dir output,
    :9)."""

    def __init__(self):
        self._last = None
        self.samples = []
        self._thread = None
        self._stop = None

    def start(self, rate_hz: float = 1.0) -> "ResourceSampler":
        """Sample periodically on a daemon thread until stop()."""
        import threading

        if self._thread is not None:
            return self
        self._stop = threading.Event()
        self.sample()                       # baseline for the first delta

        def loop():
            while not self._stop.wait(1.0 / rate_hz):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        return self.summary()

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        cpu = [s["cpu_pct"] for s in self.samples]
        rss = [s["rss_mb"] for s in self.samples]
        return {"n": len(self.samples),
                "cpu_pct_mean": sum(cpu) / len(cpu),
                "cpu_pct_max": max(cpu),
                "rss_mb_max": max(rss)}

    @staticmethod
    def _read():
        import os
        import time as _t
        with open(f"/proc/{os.getpid()}/stat") as f:
            parts = f.read().split()
        utime, stime = int(parts[13]), int(parts[14])
        rss_pages = int(parts[23])
        tick = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        return (_t.monotonic(), (utime + stime) / tick, rss_pages * page)

    def sample(self) -> dict:
        now = self._read()
        if self._last is None:
            self._last = now
            return {"cpu_pct": 0.0, "rss_mb": now[2] / 1e6}
        dt = max(now[0] - self._last[0], 1e-9)
        cpu = 100.0 * (now[1] - self._last[1]) / dt
        self._last = now
        rec = {"cpu_pct": cpu, "rss_mb": now[2] / 1e6}
        self.samples.append(rec)
        return rec
