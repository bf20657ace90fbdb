"""Eth2 utilities: SSZ hashing, signing domains, spec containers, builder
registrations, keystores, deposits, ENRs, EIP-712 and networks.

Copies of the JAX package's `eth2util` modules the node's duty workflow
and the cluster's identity and configuration need, with their imports
rewritten to this package (ref: eth2util/ — signing domains, spec-exact
SSZ merkleization, EIP-2335 keystores, deposit data, ENR helpers).
"""
