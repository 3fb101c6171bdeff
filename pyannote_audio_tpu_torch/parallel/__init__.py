from .mesh import (Mesh, broadcast_from_host0, gather_shards, make_mesh,
                   map_shards, normalize_device, pad_to_devices, replicate,
                   shard_batch)

__all__ = ["Mesh", "make_mesh", "shard_batch", "pad_to_devices",
           "broadcast_from_host0", "gather_shards", "map_shards",
           "normalize_device", "replicate"]
