"""Cluster configuration formats: definition, lock, keystores.

Mirrors ref: cluster/ — cluster-definition.json (operators, threshold,
fork version, signatures — ref cluster/definition.go, schema
docs/configuration.md:15-52) and cluster-lock.json (adds distributed
validators: group pubkeys, pubshares, aggregate + per-node signatures —
ref cluster/lock.go, docs/configuration.md:64-80).

Hashing: canonical-JSON sha256 (this framework's wire format is JSON
end-to-end; the reference hashes SSZ — the role of the hash, as the signed
identity of the config, is identical). Signatures: secp256k1 per operator
(k1util) and BLS aggregate over the lock hash.
"""

from charon_tpu_torch.cluster.definition import ClusterDefinition, Operator  # noqa: F401
from charon_tpu_torch.cluster.lock import ClusterLock, DistributedValidator  # noqa: F401
