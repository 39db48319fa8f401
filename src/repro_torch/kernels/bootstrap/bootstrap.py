"""Bindings of the hand-written Hopper bootstrap kernels
(``csrc/bootstrap.cu``), the ports of the Pallas TPU kernels
``repro/kernels/bootstrap/bootstrap.py:bootstrap_partials`` and
``:bootstrap_means``."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _cuda


@functools.cache
def partials_geometry() -> tuple[int, int, int, int]:
    """(columns a launch, replicates a block, rows a tile, most row blocks
    a replicate group) of the partials kernel, from the library."""
    vals = [ctypes.c_int() for _ in range(4)]
    _cuda.check(_cuda.library().repro_bootstrap_partials_geometry(
        *(ctypes.byref(v) for v in vals)), "repro_bootstrap_partials_geometry")
    return tuple(v.value for v in vals)


#: (device index, stream) -> (f32 row-block sums, uint32 arrival counters)
_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(scores: torch.Tensor, stream: int, n_boot: int,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch of the partials kernel for an (n, m) call: the row blocks'
    sums, (n_groups, min(n_tiles, blocks), 2 * min(m, cols), reps) floats,
    and n_groups arrival counters, n_groups = ceil(n_boot / reps).  Kept
    per (device, stream) and grown when a call needs more: calls on one
    stream run in order, so one workspace serves them all, and every call
    leaves the counters at zero (they are zeroed once, when allocated)."""
    n, m = scores.shape
    cols, reps, rows, blocks = partials_geometry()
    n_groups = -(-n_boot // reps)
    n_floats = n_groups * min(-(-n // rows), blocks) * 2 * min(m, cols) * reps
    key = (scores.device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_groups:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(n_floats, have[0]), dtype=torch.float32,
                          device=scores.device),
              # int32 storage for the kernel's uint32 counters
              torch.zeros(max(n_groups, have[1]), dtype=torch.int32,
                          device=scores.device))
        _WORKSPACES[key] = ws
    return ws


def bootstrap_partials(
    scores: torch.Tensor,  # (n, m) f32, CUDA, NaN = unscorable
    seed: int,
    start: int,            # absolute example offset of row 0
    *,
    n_boot: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum w*x, sum w)`` f32 replicate pairs of shape (n_boot, m) on
    the card, any m.  One launch (one device kernel) per group of at most
    8 columns, in ascending order, each writing its slice of the outputs;
    a column's bits are those of a call on that column alone, since the
    weights depend only on (seed, example, replicate)."""
    _cuda.require_cuda(scores, "scores", torch.float32)
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"scores must be a contiguous (n, m) matrix: {scores.shape}")
    n, m = scores.shape
    if n == 0 or m == 0 or n_boot <= 0:
        raise ValueError(f"unsupported: n={n} m={m} n_boot={n_boot}")
    lib = _cuda.library()
    group = partials_geometry()[0]
    stream = _cuda.stream_of(scores)
    part, arrivals = workspace(scores, stream, n_boot)
    swx = torch.empty((n_boot, m), dtype=torch.float32, device=scores.device)
    sw = torch.empty_like(swx)
    for j in range(0, m, group):
        err = lib.repro_bootstrap_partials(
            scores.data_ptr() + 4 * j, m, n, min(group, m - j), n_boot,
            seed & 0xFFFFFFFF, start & 0xFFFFFFFF, part.data_ptr(), part.numel(),
            arrivals.data_ptr(), arrivals.numel(), swx.data_ptr() + 4 * j,
            sw.data_ptr() + 4 * j, stream,
        )
        _cuda.check(err, "bootstrap_partials")
        _cuda.count_launch(bootstrap_partials)
    return swx, sw


#: kernel launches since the count was last set to 0
bootstrap_partials.launches = 0


def bootstrap_means(
    data: torch.Tensor,  # (n,) f32, CUDA
    seed: int,
    *,
    n_boot: int,
) -> torch.Tensor:
    """(n_boot,) f32 Poisson-bootstrap means on the card, any n_boot >= 1."""
    _cuda.require_cuda(data, "data", torch.float32)
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous (n,) vector: {data.shape}")
    n = data.shape[0]
    if n == 0 or n_boot <= 0 or n >= 2**31:
        raise ValueError(f"unsupported: n={n} n_boot={n_boot}")
    lib = _cuda.library()
    n_tiles = math.ceil(n / lib.repro_bootstrap_tile_rows())
    tiles = torch.empty((2, n_tiles, n_boot), dtype=torch.float32,
                        device=data.device)
    means = torch.empty((n_boot,), dtype=torch.float32, device=data.device)
    err = lib.repro_bootstrap_means(
        data.data_ptr(), n, n_boot, seed & 0xFFFFFFFF, tiles[0].data_ptr(),
        tiles[1].data_ptr(), means.data_ptr(), _cuda.stream_of(data),
    )
    _cuda.check(err, "bootstrap_means")
    _cuda.count_launch(bootstrap_means)
    return means


#: kernel launches since the count was last set to 0
bootstrap_means.launches = 0
