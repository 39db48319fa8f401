from repro_torch.kernels.ssd.ops import ssd_apply
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.kernels.ssd.ssd import ssd

__all__ = ["ssd", "ssd_apply", "ssd_ref"]
