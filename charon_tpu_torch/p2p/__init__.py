"""Peer networking: asyncio TCP mesh with typed messages.

Mirrors ref: p2p/ (libp2p TCP host, typed request/response streams,
connection gating to cluster peers, continuous ping — p2p/p2p.go:36,
p2p/sender.go, p2p/gater.go, p2p/ping.go) re-designed on asyncio: one
length-prefixed TCP connection per peer pair, protocol-tagged frames
dispatched to registered handlers, secp256k1-authenticated handshake.
"""

from charon_tpu_torch.p2p.codec import (  # noqa: F401
    CodecError,
    decode,
    decode_binary,
    encode,
    encode_binary,
    register,
)

try:
    from charon_tpu_torch.p2p.transport import P2PNode, PeerSpec  # noqa: F401
except ModuleNotFoundError as e:  # pragma: no cover — the TCP stack needs
    # the `cryptography` package (k1 identity + AEAD framing); hosts
    # without it (codec-only tools, bench_wire.py, jax-less CI images)
    # still get the wire codec — the in-memory simnet never dials.
    # Only the known-optional dependency is masked: anything else
    # missing is a real packaging bug and must surface.
    if e.name != "cryptography":
        raise
    P2PNode = PeerSpec = None  # type: ignore[assignment]
