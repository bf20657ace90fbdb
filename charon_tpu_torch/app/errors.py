"""Structured errors: fields + captured stack traces on exceptions.

Mirrors ref: app/errors + app/z — the reference replaces stdlib errors
with a structured type carrying zap fields and a creation stack trace,
wrapped as it crosses layers so logs show WHERE and WITH WHAT context a
failure happened. Python exceptions already chain (__cause__) and carry
tracebacks once RAISED; what they lack is (a) key-value context fields
and (b) a stack for errors that are constructed and logged without ever
being raised. This module adds both, the Python way:

    raise StructuredError("peer handshake failed", peer=idx, addr=addr)

    try:
        await dial()
    except OSError as e:
        raise wrap(e, "relay dial failed", relay=addr) from e

    log.error("duty failed", exc=e, **fields_of(e))  # merged chain fields

`fields_of` aggregates fields along the full __cause__/__context__ chain
(outermost wins on key conflicts), so a log site sees every layer's
context without manual threading — the analogue of the reference's
fields accumulating through errors.Wrap (ref: errors.go Wrap).
"""

from __future__ import annotations

import traceback


class StructuredError(Exception):
    """An error with key-value context fields and a creation stack.

    The creation stack matters for the construct-log-don't-raise pattern
    (ref: errors.go zap.StackSkip): `err.stack()` works whether or not
    the exception was ever raised.
    """

    def __init__(self, msg: str, **fields):
        super().__init__(msg)
        self.fields = fields
        # captured at construction, excluding this frame
        self._stack = traceback.extract_stack()[:-1]

    def stack(self) -> str:
        tb = self.__traceback__
        if tb is not None:  # raised: the real traceback is better
            return "".join(traceback.format_tb(tb))
        return "".join(traceback.format_list(self._stack))

    def __str__(self) -> str:
        base = super().__str__()
        if not self.fields:
            return base
        kv = " ".join(f"{k}={v!r}" for k, v in self.fields.items())
        return f"{base} [{kv}]"


def new(msg: str, **fields) -> StructuredError:
    """ref: errors.New — construct without raising."""
    return StructuredError(msg, **fields)


def sentinel(msg: str) -> StructuredError:
    """ref: errors.NewSentinel — module-level marker errors whose
    creation stack is noise; wrap() them at first return."""
    err = StructuredError(msg)
    err._stack = []
    return err


def wrap(err: BaseException, msg: str, **fields) -> StructuredError:
    """ref: errors.Wrap — layer a message + fields over a cause.
    Raise the result `from err` (or not — the cause is linked either
    way for fields_of / is_any)."""
    out = StructuredError(msg, **fields)
    out.__cause__ = err
    return out


def fields_of(err: BaseException | None) -> dict:
    """Merged fields along the cause chain, outermost layer winning
    (ref: the z.Field accumulation through wrapped errors)."""
    merged: dict = {}
    seen: set[int] = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, StructuredError):
            for k, v in err.fields.items():
                merged.setdefault(k, v)
        err = err.__cause__ or (
            None if err.__suppress_context__ else err.__context__
        )
    return merged


def is_any(err: BaseException | None, *sentinels: BaseException) -> bool:
    """ref: errors.Is over the chain — identity match against sentinel
    errors anywhere in the cause chain."""
    targets = {id(s) for s in sentinels}
    seen: set[int] = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if id(err) in targets:
            return True
        err = err.__cause__ or (
            None if err.__suppress_context__ else err.__context__
        )
    return False
