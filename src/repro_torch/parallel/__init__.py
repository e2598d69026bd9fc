"""Device placement of the port's serving paths (``sharding``): the
topology signature that keys the warm-template registries, and the
one-device rule for a serving mesh."""
from repro_torch.parallel.sharding import (  # noqa: F401
    mesh_devices,
    mesh_signature,
    require_one_device,
)

__all__ = ["mesh_signature", "mesh_devices", "require_one_device"]
