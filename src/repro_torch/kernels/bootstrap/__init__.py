from repro_torch.kernels.bootstrap.bootstrap import (
    bootstrap_means,
    bootstrap_partials,
)
from repro_torch.kernels.bootstrap.ref import (
    bootstrap_means_ref,
    bootstrap_partials_ref,
    mix_bits,
    poisson1_weight,
)

__all__ = [
    "bootstrap_means",
    "bootstrap_means_ref",
    "bootstrap_partials",
    "bootstrap_partials_ref",
    "mix_bits",
    "poisson1_weight",
]
