"""Machine-checked project invariants.

Every perf/robustness change established an invariant by convention —
monotonic clocks in scheduling code (the `SlotCoalescer._arm` wall-clock
bug), typed errors at trust boundaries, a jax-free port with torch-free
host modules, append-only codec wire ids, race-free shared state — and
each was enforced only by whoever remembered it. This package makes them
enforcement, not lore:

  lint.py            AST lint framework + CLI
                     (`python -m charon_tpu_torch.analysis.lint charon_tpu_torch/ chip_smoke.py`)
  rule_*.py          one module per project rule, each grounded in a
                     real past bug (module docstrings cite them)
  sanitizer.py       runtime concurrency sanitizer: lock-order cycle
                     detection + thread/asyncio-task leak detectors
  schema_check.py    append-only wire-schema contract for p2p/codec
                     against tests/testdata/wire_schema.json
  metrics_check.py   app/metrics.py <-> docs/metrics.md catalogue sync
  flightrec_check.py append-only flight-recorder event vocabulary against
                     tests/testdata/flightrec_schema.json

Everything here imports neither torch nor jax (and lints itself for it):
these gates run on any host, with or without a card. The JAX package's
device-graph analyzer (jaxpr_check) has no counterpart: the port traces
no jaxpr.
"""
