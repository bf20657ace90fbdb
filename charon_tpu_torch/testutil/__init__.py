"""Test substrate: beaconmock, validatormock and the in-process cluster
(simnet), copies of the JAX package's (ref: testutil/beaconmock,
testutil/validatormock, app/app.go:862-897 simnet wiring). The simnet
also runs a cluster's nodes as tenants of one CryptoPlaneService.
`golden.py` holds the golden-file assertions.
"""
