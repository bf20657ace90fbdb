"""Distributed key generation and key resharing: the FROST ceremony
(`frost.py`), the in-memory ceremony from a signed cluster definition to
a cluster lock and keystores (`ceremony.py`) and Desmedt-Jajodia
resharing (`reshare.py`), copies of the JAX package's host protocols
whose verification waves run on the port's engine (ops/blsops.BlsEngine)
when one is passed."""
