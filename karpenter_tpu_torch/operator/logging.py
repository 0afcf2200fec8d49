"""Structured logging plane.

Mirror of the reference's pkg/operator/logging (logging.go): a leveled,
key=value structured logger (the zapr analog), a `NOP` logger used to mute
noisy paths (the reference silences its disruption simulations with
NopLogger, disruption/helpers.go:84,93), and `with_values` child loggers
carrying controller context (injection.WithControllerName analog).

Kept dependency-free on purpose: records go to stderr as single lines
(`level=info controller=provisioner msg="..." pods=12`), machine-grepable
the way production structured logs are, and a test can swap the sink.

The port's copy of ``karpenter_tpu/operator/logging.py`` (imports changed).
"""

from __future__ import annotations

import sys
import threading
import time

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_ALIASES = {"warning": "warn", "err": "error"}

# ambient key=value contributors consulted on every emission — the JAX
# package's tracing plane (karpenter_tpu/obs, not ported yet) injects
# trace=<id> here so a grep for one round's trace id yields its full log
# slice. Providers are lowest-precedence
# (with_values context and per-call kv override them) and must be cheap;
# a raising provider is ignored rather than breaking the record.
_CONTEXT_PROVIDERS: list = []


def add_context_provider(fn) -> None:
    """Register ``fn() -> dict`` as an ambient context source."""
    if fn not in _CONTEXT_PROVIDERS:
        _CONTEXT_PROVIDERS.append(fn)


def remove_context_provider(fn) -> None:
    try:
        _CONTEXT_PROVIDERS.remove(fn)
    except ValueError:
        pass


def _resolve_level(level) -> int:
    """Normalize case and common spellings; unknown values fall back to
    info WITH a visible complaint rather than silently."""
    if isinstance(level, int):
        return level
    name = _ALIASES.get(str(level).strip().lower(), str(level).strip().lower())
    n = LEVELS.get(name)
    if n is None:
        print(f'level=warn msg="unknown log level {level!r}, using info"',
              file=sys.stderr)
        return LEVELS["info"]
    return n


def root_cause(exc: BaseException) -> str:
    """Innermost exception class name along the __cause__/__context__
    chain — the label fallback paths attribute rescues to (a bare
    ``RpcError`` says the wire broke; ``KeyError`` inside it says the
    payload did)."""
    seen = {id(exc)}
    while True:
        if exc.__cause__ is not None:
            nxt = exc.__cause__
        elif exc.__suppress_context__:
            nxt = None  # `raise X from None`: the context was disowned
        else:
            nxt = exc.__context__
        if nxt is None or id(nxt) in seen:
            return type(exc).__name__
        seen.add(id(nxt))
        exc = nxt


def _escape(v) -> str:
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return s.replace("\n", "\\n").replace("\r", "\\r")


def _fmt_value(v) -> str:
    """One token per value: quotes/newlines escaped so a record is always
    exactly one machine-grepable line."""
    s = _escape(v)
    return f'"{s}"' if (" " in s or s == "" or "\\" in s) else s


class Logger:
    def __init__(self, level="info", sink=None, values: dict | None = None,
                 clock=None):
        self._level = _resolve_level(level)
        self._sink = sink  # callable(str) | None = stderr
        self._values = dict(values or {})
        self._clock = clock
        self._lock = threading.Lock()

    # -- context ---------------------------------------------------------
    def with_values(self, **values) -> "Logger":
        """Child logger carrying extra key=value context (zapr .WithValues /
        the controller-name injection)."""
        child = Logger(level=self._level, sink=self._sink,
                       values={**self._values, **values}, clock=self._clock)
        child._lock = self._lock  # children share the parent's sink lock
        return child

    # -- emission --------------------------------------------------------
    def _emit(self, level: str, msg: str, kv: dict):
        if LEVELS[level] < self._level:
            return
        now = self._clock.now() if self._clock is not None else time.time()
        parts = [f"ts={now:.3f}", f"level={level}"]
        ambient: dict = {}
        for fn in _CONTEXT_PROVIDERS:
            try:
                ambient.update(fn() or {})
            except Exception:
                pass  # ambient context must never break a record
        for k, v in {**ambient, **self._values, **kv}.items():
            parts.append(f"{k}={_fmt_value(v)}")
        parts.append(f'msg="{_escape(msg)}"')
        line = " ".join(parts)
        with self._lock:
            if self._sink is not None:
                self._sink(line)
            else:
                print(line, file=sys.stderr)

    def debug(self, msg: str, **kv):
        self._emit("debug", msg, kv)

    def info(self, msg: str, **kv):
        self._emit("info", msg, kv)

    def warn(self, msg: str, **kv):
        self._emit("warn", msg, kv)

    def error(self, msg: str, **kv):
        self._emit("error", msg, kv)

    @property
    def enabled(self) -> bool:
        return True


class NopLogger(Logger):
    """Discards everything — wraps noisy paths (the reference mutes its
    disruption simulations this way, helpers.go:84)."""

    def __init__(self):
        super().__init__(level="error")

    def _emit(self, level, msg, kv):
        pass

    def with_values(self, **values) -> "NopLogger":
        return self

    @property
    def enabled(self) -> bool:
        return False


NOP = NopLogger()


def make_logger(level: str | None = None, sink=None, clock=None) -> Logger:
    """Root logger honoring Options.log_level / KARPENTER_LOG_LEVEL."""
    if level is None:
        from karpenter_tpu_torch.utils.envknobs import env_str

        level = env_str("KARPENTER_LOG_LEVEL", "info")
    return Logger(level=level, sink=sink, clock=clock)
