"""wire(): stitch the core workflow components into the duty pipeline.

Mirrors ref: core/interfaces.go:282-357 core.Wire — a pure subscription
graph with optional wrapping (tracing, tracking, async-retry) applied to
every edge. Components are duck-typed; any may be replaced by a test fake
(the reference proves this pattern with its simnet, ref: app/app.go:862).

Subscription graph (ref: core/interfaces.go:336-356):

    scheduler --duties--> fetcher --proposals--> consensus --decided--> dutydb
    validatorapi --partials--> parsigdb --internal--> parsigex --> peers
    parsigdb --threshold--> sigagg --> aggsigdb
                                  \\--> broadcaster
"""

from __future__ import annotations

from typing import Awaitable, Callable, Sequence

WireOption = Callable[[str, Callable], Callable]


def tracing(tracer=None) -> WireOption:
    """wire() option (sibling of app/metrics.instrument and
    core/tracker.tracking): every subscription edge runs inside a span
    rooted at the DETERMINISTIC duty trace id (app/tracer.duty_trace_id),
    so Scheduler→Fetcher→Consensus→DutyDB→ValidatorAPI→ParSigDB→ParSigEx
    →SigAgg→AggSigDB→Broadcaster each contribute one nested span per
    duty, and spans recorded on different nodes merge into one
    cross-node trace (ref: core/tracing.go + core.WithTracing,
    app/app.go:569). Attrs: duty, slot, duty type, and the pubkey count
    of dict-shaped payloads (duty-set fan-in width)."""

    def option(name: str, fn: Callable) -> Callable:
        async def wrapped(duty, *args, **kwargs):
            # lazy: core must not import app at module load
            from charon_tpu_torch.app.tracer import span

            attrs = {"duty_type": str(getattr(duty, "type", ""))}
            if args and hasattr(args[0], "keys"):
                attrs["pubkeys"] = len(args[0])
            with span(name, duty=duty, tracer=tracer, **attrs):
                return await fn(duty, *args, **kwargs)

        return wrapped

    return option


def wire(
    *,
    scheduler,
    fetcher,
    consensus,
    dutydb,
    validatorapi,
    parsigdb,
    parsigex,
    sigagg,
    aggsigdb,
    broadcaster,
    options: Sequence[WireOption] = (),
) -> None:
    def wrap(name: str, fn: Callable) -> Callable:
        for opt in options:
            fn = opt(name, fn)
        return fn

    scheduler.subscribe_duties(wrap("fetcher.fetch", fetcher.fetch))
    fetcher.register_consensus(wrap("consensus.propose", consensus.propose))
    fetcher.register_agg_sig_db(wrap("aggsigdb.await", aggsigdb.await_))
    fetcher.register_await_attestation(
        wrap("dutydb.await_attestation", dutydb.await_attestation)
    )
    consensus.subscribe(wrap("dutydb.store", dutydb.store))
    validatorapi.register_await_attestation(dutydb.await_attestation)
    validatorapi.register_await_proposal(dutydb.await_proposal)
    validatorapi.register_await_aggregated_attestation(
        dutydb.await_aggregated_attestation
    )
    validatorapi.register_await_sync_contribution(
        dutydb.await_sync_contribution
    )
    validatorapi.register_await_sync_message(dutydb.await_sync_message)
    validatorapi.register_pubkey_by_attestation(dutydb.pubkey_by_attestation)
    validatorapi.register_await_aggregated(aggsigdb.await_)
    validatorapi.register_get_duty_definition(scheduler.get_duty_definition)
    validatorapi.subscribe(wrap("parsigdb.store_internal", parsigdb.store_internal))
    parsigdb.subscribe_internal(wrap("parsigex.broadcast", parsigex.broadcast))
    parsigex.subscribe(wrap("parsigdb.store_external", parsigdb.store_external))
    parsigdb.subscribe_threshold(wrap("sigagg.aggregate", sigagg.aggregate))
    sigagg.subscribe(wrap("aggsigdb.store", aggsigdb.store_set))
    sigagg.subscribe(wrap("broadcaster.broadcast", broadcaster.broadcast))
