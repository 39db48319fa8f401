"""On-disk storage of the port: the DeltaLite table the response cache and
the streaming spill manifests live in."""

from repro_torch.storage.deltalite import CommitConflict, DeltaLite
from repro_torch.storage.spill import ChunkManifest

__all__ = ["ChunkManifest", "CommitConflict", "DeltaLite"]
