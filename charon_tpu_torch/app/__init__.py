"""App infrastructure the duty workflow calls: structured logging and
errors, deadline-bounded retries, exponential backoff, feature flags,
duty-rooted tracing, the beacon-client wrapper's error types, the k1
node identity, the lifecycle manager, fork-join, the private-key lock and
the version window.

Copies of the JAX package's `app` modules (ref: app/ — log/z, errors,
retry, expbackoff, featureset, tracer, eth2wrap, k1util, lifecycle,
forkjoin, privkeylock, version), imports rewritten to this package. The
node's run() wiring (app/run.py) comes later.
"""
