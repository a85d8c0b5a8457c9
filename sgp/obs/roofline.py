"""Speed-of-light accounting for the hot kernel paths.

A measured rate means little without the attainable bound next to it.
This module computes, from the device's data-sheet peaks
(:mod:`sgp.obs.device`), the floor time of each SpMM representation
and of the fused IID training step, so ``bench.py`` can report
``*_pct_of_roofline`` beside bare rates.

The bound of a program is ``max(bytes_moved / HBM bandwidth, flops /
peak)`` — whichever wall the program hits first. The matmul peak follows
the operand precision: bf16 inputs run at the bf16 tensor-core rate, f32
at default precision at the TF32 rate, f32 at precision "highest" at the
plain f32 rate. Everything here is host-side arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass

_RATE = {"bf16": "bf16_flops", "default": "tf32_flops",
         "highest": "fp32_flops"}


@dataclass
class Bound:
    """A program's floor: seconds, and which wall sets it."""
    seconds: float
    hbm_seconds: float
    flop_seconds: float

    @property
    def limiter(self) -> str:
        return "hbm" if self.hbm_seconds >= self.flop_seconds else "flops"

    def pct_of(self, measured_seconds: float) -> float:
        """Fraction of the attainable rate the measurement achieved."""
        return self.seconds / max(measured_seconds, 1e-12)


def _bound(peaks: dict, bytes_moved: float, flops: float,
           precision: str) -> Bound:
    t_hbm = bytes_moved / peaks["hbm_bytes_s"]
    t_flop = flops / peaks[_RATE[precision]]
    return Bound(max(t_hbm, t_flop), t_hbm, t_flop)


def dense_spmm_bound(peaks: dict, n: int, f: int, itemsize: int = 4,
                     precision: str = "default") -> Bound:
    """One ``[N, N] @ [N, F]`` pass: the operator read dominates
    bytes."""
    bytes_moved = n * n * itemsize + 2 * n * f * 4
    flops = 2.0 * n * n * f
    return _bound(peaks, bytes_moved, flops, precision)


def bsr_spmm_bound(peaks: dict, nnzb: int, n_block_rows: int, f: int,
                   block: int = 128, blk_itemsize: int = 2,
                   x_itemsize: int = 4) -> Bound:
    """Block-sparse SpMM floor: the block store read once, one x tile
    read per stored block and F tile, each output tile written once."""
    f_tiles = max(1, -(-f // block))
    bytes_moved = (nnzb * block * block * blk_itemsize
                   + nnzb * block * block * x_itemsize * f_tiles
                   + n_block_rows * block * block * x_itemsize * f_tiles)
    flops = 2.0 * nnzb * block * block * block * f_tiles
    return _bound(peaks, bytes_moved, flops,
                  "bf16" if blk_itemsize == 2 else "default")


def coo_spmm_bound(peaks: dict, n_edges: int, n: int, f: int,
                   itemsize: int = 4) -> Bound:
    """Gather + segment-sum floor: per edge one x-row read and one
    message write/read around the segment reduction."""
    bytes_moved = (n_edges * (4 + 4 + itemsize)            # src/dst/w
                   + 3 * n_edges * f * itemsize            # gather + msg
                   + n * f * itemsize)                     # output
    flops = 2.0 * n_edges * f
    return _bound(peaks, bytes_moved, flops, "highest")


def iid_step_bound(peaks: dict, batch: int, row_bytes: int,
                   flops_per_step: float, param_bytes: int = 0,
                   precision: str = "default") -> dict:
    """The fused IID train step's floor: the sample-row gather's bytes,
    the fwd/bwd matmuls at the peak for ``precision``, and Adam's
    read/write of the parameter state. Returns the perfectly
    overlapped floor (max) and the serial floor (sum)."""
    t_gather = batch * row_bytes / peaks["hbm_bytes_s"]
    t_flop = flops_per_step / peaks[_RATE[precision]]
    t_adam = param_bytes / peaks["hbm_bytes_s"]
    return {"t_gather_bound_s": t_gather, "t_flop_bound_s": t_flop,
            "t_adam_bound_s": t_adam,
            "floor_overlap_s": max(t_gather, t_flop, t_adam),
            "floor_serial_s": t_gather + t_flop + t_adam}
