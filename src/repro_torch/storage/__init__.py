"""On-disk storage of the port: the DeltaLite table the response cache
lives in."""

from repro_torch.storage.deltalite import CommitConflict, DeltaLite

__all__ = ["CommitConflict", "DeltaLite"]
