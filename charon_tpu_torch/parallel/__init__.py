"""The slot crypto plane: the whole slot's verify and recombine work as a
few batched programs, with the validator axis split over devices.

  mesh.py  SlotCryptoPlane (the ten programs and their host API, the
           shards run at once), make_mesh (the plane's shards: a list of
           torch devices) and make_mesh_2d (hosts x devices rows)
"""

from charon_tpu_torch.parallel.mesh import (  # noqa: F401
    SlotCryptoPlane,
    make_mesh,
    make_mesh_2d,
)
