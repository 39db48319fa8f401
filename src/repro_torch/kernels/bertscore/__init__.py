from repro_torch.kernels.bertscore.bertscore import bertscore_pr
from repro_torch.kernels.bertscore.ops import bertscore
from repro_torch.kernels.bertscore.ref import bertscore_ref

__all__ = ["bertscore", "bertscore_pr", "bertscore_ref"]
