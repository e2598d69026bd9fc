"""Device placement of the port: logical-axis rules and specs with their
divisibility fallbacks, and the serving paths' topology signature
(``sharding``); tensors split over a mesh (``placement``); and the
collectives between a mesh's positions (``collectives``)."""
from repro_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    per_position,
    pmin,
    psum,
    scatter,
)
from repro_torch.parallel.placement import (  # noqa: F401
    NamedSharding,
    PlacedTensor,
    device_put,
    gather,
)
from repro_torch.parallel.sharding import (  # noqa: F401
    RULES,
    PartitionSpec,
    logical_to_spec,
    mesh_devices,
    mesh_signature,
    pad_vocab,
    resolve_param_specs,
    shard,
)

__all__ = ["mesh_signature", "mesh_devices", "all_gather", "pmin", "psum",
           "per_position", "scatter", "RULES", "PartitionSpec", "shard",
           "logical_to_spec", "resolve_param_specs", "pad_vocab",
           "NamedSharding", "PlacedTensor", "device_put", "gather"]
