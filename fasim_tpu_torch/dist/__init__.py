"""Mesh and sharded execution of the scan step (counterpart of
fasim_tpu/dist/__init__.py).

Two axes of parallelism, as in the JAX package:

  * ``seg``  — data-parallel over the 5 kb DNA segments (independent by
    construction of the overlapping segmentation, fastsim.h:71-90);
  * ``rule`` — over the 48 pairing-rule transforms of each segment.

The production path does not use a mesh: the batched driver round-robins
its batches over one engine a device (scan/batched.py), and the
multi-host runner (dist/runner.py) shards the work items over processes.
The mesh step here is the sharded expression of the same scan, for the
dry run (dist/dryrun.py).  No collective runs: each (seg, rule) shard is
scanned by an engine on its own device, through K5 (the engine's
`colmax_dev`), and the shards are concatenated in (seg, rule) order on
the mesh's first device.  The results do not depend on the mesh shape.

Differences from fasim_tpu.dist: the mesh is a (seg, rule) object array
of torch devices (a device may repeat, so two shards can share one card)
instead of a JAX `Mesh`; `sharded_scan_step(mesh, rna)` takes the query
and builds the engines itself, where the JAX step takes the engine's
profile arrays; S and T need not divide by the mesh's axes (the shards
may be uneven).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BYTE_SAT

AXES = ("seg", "rule")


def make_mesh(n_seg: int = 0, n_rule: int = 1, devices=None) -> np.ndarray:
    """A (seg, rule) mesh over `devices` (default: every CUDA device this
    process sees): an object array of torch devices of shape (n_seg,
    n_rule).  n_seg=0 uses all remaining devices.  A device may be listed
    more than once."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_seg == 0:
        n_seg = max(1, len(devices) // n_rule)
    n = n_seg * n_rule
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return grid.reshape(n_seg, n_rule)


def byte_break(colmax: torch.Tensor) -> torch.Tensor:
    """Device-side kernels.scan_codes.apply_byte_break (sswNew.cpp:384-386):
    zero everything from the first column max >= BYTE_SAT on, on the
    tensor's own device."""
    sat = (colmax >= BYTE_SAT).to(torch.int32)
    return torch.where(sat.cummax(-1).values == 0, colmax,
                       torch.zeros((), dtype=colmax.dtype,
                                   device=colmax.device))


def scan_step(codes_thresh, codes_ssw, engine) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Scan step for a batch of (segment, transform) pairs on `engine`'s
    device.  codes_*: engine codes int[S, T, N] (numpy or a tensor).
    Returns (thresh int32[S, T], colmax int32[S, T, N] after the byte
    break), both on the engine's device.  The host derives min_score =
    int(0.8 * thresh) and runs the candidate stage on the colmax rows."""
    thresh = engine.colmax_dev(codes_thresh, "thresh").amax(-1)
    return thresh, byte_break(engine.colmax_dev(codes_ssw, "ssw"))


def sharded_scan_step(mesh: np.ndarray, rna: np.ndarray):
    """scan_step over the mesh: segments split over ``seg``, transforms
    over ``rule``, each shard scanned on an engine on its device (one
    engine a distinct device, the query replicated), the shards
    concatenated in (seg, rule) order on the mesh's first device.
    Returns step(codes_thresh, codes_ssw) -> (thresh, colmax)."""
    from ..kernels.engine import TorchScanEngine

    engines = {}
    for d in mesh.flat:
        if d not in engines:
            engines[d] = TorchScanEngine(rna, device=d)
    home = mesh.flat[0]
    n_seg, n_rule = mesh.shape

    def step(codes_thresh, codes_ssw):
        t_rows, c_rows = [], []
        for i, (ct_s, cs_s) in enumerate(zip(
                torch.as_tensor(codes_thresh).tensor_split(n_seg, dim=0),
                torch.as_tensor(codes_ssw).tensor_split(n_seg, dim=0))):
            t_row, c_row = [], []
            for j, (ct, cs) in enumerate(zip(ct_s.tensor_split(n_rule, 1),
                                             cs_s.tensor_split(n_rule, 1))):
                thresh, colmax = scan_step(ct.contiguous(), cs.contiguous(),
                                           engines[mesh[i, j]])
                t_row.append(thresh.to(home))
                c_row.append(colmax.to(home))
            t_rows.append(torch.cat(t_row, dim=1))
            c_rows.append(torch.cat(c_row, dim=1))
        return torch.cat(t_rows, dim=0), torch.cat(c_rows, dim=0)

    return step
