"""Eth2 utilities: SSZ hashing, signing domains, spec containers and
builder registrations.

Copies of the JAX package's `eth2util` modules the node's duty workflow
needs (ssz, signing, spec, registration), with their imports rewritten
to this package (ref: eth2util/ — signing domains, spec-exact SSZ
merkleization). Keystores, deposits and ENRs come with the node wiring.
"""
