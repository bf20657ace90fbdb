"""Distributed key generation and key resharing: the FROST ceremony
(`frost.py`) and Desmedt-Jajodia resharing (`reshare.py`), copies of the
JAX package's host protocols whose verification waves run on the port's
engine (ops/blsops.BlsEngine) when one is passed."""
