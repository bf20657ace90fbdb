"""Structured logging with context-carried fields and topics.

Mirrors ref: app/log + app/z — loggers carry a topic, contexts carry
fields that every log line in that call tree inherits
(log/log.go:32-43 WithCtx/WithTopic), and error/warn counters feed the
health checks (app/health). contextvars replace Go's context values.
"""

from __future__ import annotations

import contextvars
import logging
import sys
from collections import defaultdict
from typing import Any

_ctx_fields: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "log_fields", default={}
)

# error/warn counters by topic — consumed by app.health
# (ref: health/checks.go reads log counters).
error_counts: dict[str, int] = defaultdict(int)
warn_counts: dict[str, int] = defaultdict(int)

_root = logging.getLogger("charon_tpu_torch")
if not _root.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).4s %(message)s")
    )
    _root.addHandler(handler)
    _root.setLevel(logging.INFO)


def init(level: str = "info") -> None:
    _root.setLevel(getattr(logging, level.upper(), logging.INFO))


def with_ctx(**fields) -> contextvars.Token:
    """Attach fields to the current context (ref: log.WithCtx)."""
    merged = {**_ctx_fields.get(), **fields}
    return _ctx_fields.set(merged)


def reset_ctx(token: contextvars.Token) -> None:
    _ctx_fields.reset(token)


def _fmt(msg: str, topic: str, fields: dict) -> str:
    all_fields = {**_ctx_fields.get(), **fields}
    # logs and traces cross-reference: a record emitted inside an active
    # span carries its trace id (ref: the reference stamps trace IDs
    # into zap fields via the log/trace bridge). Explicit fields win.
    if "trace_id" not in all_fields:
        from charon_tpu_torch.app.tracer import current_ctx

        ctx = current_ctx()
        if ctx is not None:
            all_fields["trace_id"] = ctx[0]
    parts = [f"[{topic}]", msg]
    parts.extend(f"{k}={v}" for k, v in all_fields.items())
    return " ".join(parts)


def debug(msg: str, topic: str = "app", **fields) -> None:
    _root.debug(_fmt(msg, topic, fields))


def info(msg: str, topic: str = "app", **fields) -> None:
    _root.info(_fmt(msg, topic, fields))


def warn(msg: str, topic: str = "app", **fields) -> None:
    warn_counts[topic] += 1
    _root.warning(_fmt(msg, topic, fields))


def error(msg: str, topic: str = "app", exc: BaseException | None = None, **fields) -> None:
    error_counts[topic] += 1
    if exc is not None:
        # structured-error chains contribute their merged context fields
        # (explicit call-site fields win — ref: app/errors field logging)
        from charon_tpu_torch.app.errors import fields_of

        for k, v in fields_of(exc).items():
            fields.setdefault(k, v)
        fields["err"] = repr(exc)
    _root.error(_fmt(msg, topic, fields))
