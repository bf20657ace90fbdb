"""Node side of the port: kernel routing, the plane's coalescer, the
multi-tenant service in front of it, and the duty workflow.

  autotune.py     KernelConfig (kernel routing), the startup tuner
                  resolve(), the persisted kernel profile and the prewarm
                  marker
  cryptoplane.py  SlotCoalescer (one plane flush per window of concurrent
                  verify/recombine submissions), FlushStats,
                  PlaneConfigError, kernel_inventory()
  cryptosvc.py    CryptoPlaneService (per-tenant admission, EDF rounds,
                  forged-flood breaker) and TenantPlane

The duty workflow, copied from the JAX package's core layer (ref:
core/interfaces.go — ten components stitched by core.Wire): immutable
frozen-dataclass values flow through async pub/sub subscriptions, and
every signature-heavy step hands whole duty-sets to the tbls registry or
to a plane instead of per-signature calls. None of these imports torch.

  types/eth2data  abstract value types (Duty, UnsignedData, SignedData)
  deadline        duty-expiry engine, SlotClock
  scheduler       slot ticker + duty resolution
  fetcher         duty input data from the beacon node
  consensus       pluggable consensus (echo); qbft + consensus_qbft
  dutydb          blocking unsigned-data store
  validatorapi    beacon-API facade for the downstream VC
  parsigdb        partial-signature store w/ threshold grouping
  parsigex        partial-signature exchange between peers
  sigagg          batched threshold aggregation
  aggsigdb        aggregated-signature store
  bcast           broadcast to the beacon node
  tracker         per-duty failure analysis; inclusion checks
  evidence        attributable Byzantine-behaviour evidence
  wire            component stitching + the tracking/tracing options
"""

from charon_tpu_torch.core.types import (  # noqa: F401
    Duty,
    DutyType,
    PubKey,
)
