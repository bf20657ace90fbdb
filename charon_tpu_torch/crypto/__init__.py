"""BLS12-381 host crypto for the PyTorch port (pure Python).

The port's own copies of the JAX package's host modules — field towers,
curve groups, RFC 9380 hash-to-curve, eth2 (ZCash) point serialization,
key generation, signing and Shamir/Lagrange threshold operations — so that
`charon_tpu_torch` imports nothing of `charon_tpu`. The device engine
(charon_tpu_torch/ops) is validated against these and against the JAX
package.

Not constant-time: secret-key operations here are for reference/testing.
"""

from charon_tpu_torch.crypto import bls, fields, g1g2, h2c, shamir  # noqa: F401
