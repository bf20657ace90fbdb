"""App infrastructure the duty workflow calls: structured logging and
errors, deadline-bounded retries, exponential backoff, feature flags,
duty-rooted tracing, and the beacon-client wrapper's error types.

Copies of the JAX package's `app` modules (ref: app/ — log/z, errors,
retry, expbackoff, featureset, tracer, eth2wrap), imports rewritten to
this package. The node's run() wiring (app/run.py) comes later.
"""
