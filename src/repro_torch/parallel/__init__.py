"""Device placement of the port's serving paths: the topology signature
that keys the warm-template registries (``sharding``) and the collectives
between a mesh's positions (``collectives``)."""
from repro_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    per_position,
    pmin,
    psum,
)
from repro_torch.parallel.sharding import (  # noqa: F401
    mesh_devices,
    mesh_signature,
)

__all__ = ["mesh_signature", "mesh_devices", "all_gather", "pmin", "psum",
           "per_position"]
