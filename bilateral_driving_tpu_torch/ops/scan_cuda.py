"""Inclusive prefix scans along rows: port of
bilateral_driving_tpu/ops/scan_pallas.py (`scan_rows`, `scan1d`).

`scan_rows(x, op)` scans each row of an (R, M) float32 or int32 tensor on
its own with op in {"sum", "max", "min"}, in x's dtype; `scan1d` scans a
1-D tensor as one row. On CUDA tensors both launch `csrc/scan.cu` once
(counted in `scan_rows.launches`), on CPU tensors they run
`scan_rows_plain`.

The kernel is a single-pass scan with decoupled look-back: its tile
counter and per-tile status words live in one scratch buffer per device and
stream, zeroed once when it is allocated (or grown) and reused by every
call through a running counter base and a new epoch per call.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

OPS = ("sum", "max", "min")
DTYPES = {torch.float32: 0, torch.int32: 1}
TILE = 8192        # elements one block scans (csrc/scan.cu kTile)
EPOCHS = 1 << 30   # epochs a status word can tell apart (csrc/scan.cu)
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


class _Scratch:
    """The look-back state of one stream: an int64 word whose low half is
    the tile counter, then one status word per tile."""

    def __init__(self, device, tiles: int):
        self.words = torch.zeros(1 + tiles, dtype=torch.int64, device=device)
        self.tiles = tiles
        self.base = 0      # the counter's value when the next call starts
        self.epoch = 0     # the last call's epoch


_scratch: dict[tuple[int, int], _Scratch] = {}


def _state(device, stream: int, tiles: int) -> _Scratch:
    key = (device.index, stream)
    s = _scratch.get(key)
    if s is None or s.tiles < tiles:
        s = _Scratch(device, max(tiles, 2 * s.tiles if s else 0))
        _scratch[key] = s
    if s.epoch + 1 == EPOCHS:
        # every epoch used: clear the words and the counter once
        s.words.zero_()
        s.base = s.epoch = 0
    return s


def scan_rows_plain(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The same scan by torch's own operators."""
    if op == "sum":
        return torch.cumsum(x, 1, dtype=x.dtype)
    if op == "max":
        return torch.cummax(x, 1).values
    if op == "min":
        return torch.cummin(x, 1).values
    raise ValueError(f"scan op {op!r} not in {OPS}")


def _launch(x: torch.Tensor, rows: int, m: int, op: str) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"scan op {op!r} not in {OPS}")
    cuda_build.require_cuda(x)
    if not x.is_contiguous() or x.dtype not in DTYPES:
        raise ValueError("scan: need a contiguous float32 or int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    tiles = rows * -(-m // TILE)
    stream = cuda_build.current_stream(x.device)
    s = _state(x.device, stream, tiles)
    fn = cuda_build.function("scan", "scan_launch",
                             [_P, _P, _I, _I, _I, _I, _P, _U, _U, _P])
    cuda_build.check(fn(x.data_ptr(), out.data_ptr(), rows, m,
                        DTYPES[x.dtype], OPS.index(op), s.words.data_ptr(),
                        s.base, s.epoch + 1, stream), "scan")
    s.base = (s.base + tiles) & 0xFFFFFFFF
    s.epoch += 1
    scan_rows.launches += 1
    return out


def scan_rows(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Inclusive prefix scan of (R, M) along axis 1, each row on its own."""
    if x.device.type == "cpu":
        return scan_rows_plain(x, op)
    if x.dim() != 2:
        raise ValueError(f"scan_rows: need an (R, M) tensor, got "
                         f"{tuple(x.shape)}")
    return _launch(x, x.shape[0], x.shape[1], op)


scan_rows.launches = 0


def scan1d(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Inclusive scan of a 1-D tensor: one row of scan_rows."""
    if x.device.type == "cpu":
        return scan_rows_plain(x[None, :], op)[0]
    if x.dim() != 1:
        raise ValueError(f"scan1d: need a 1-D tensor, got {tuple(x.shape)}")
    return _launch(x, 1, x.shape[0], op)
