"""Multi-device dry run of the port (counterpart of
__graft_entry__.dryrun_multichip, without JAX).

`dryrun_multichip(devices)` validates the multi-device paths on the given
torch devices (a device may repeat: two engines can share one card) at
small shapes:

  1. the production path: the batched driver's round-robin over one
     engine a listed device is astuple-identical to one engine, on a
     planted-homology input;
  2. `dist.sharded_scan_step` on a (seg, rule) mesh of the devices agrees
     with the scalar golden kernels (`kernels/ref.sw_max`, `sw_colmax`);
  3. meg3_sub3 (3 records) through the round-robin and through the
     runner's shard/gather/merge (`scan_distributed`, one process) writes
     output files byte-identical to oracle/golden/meg3_sub3.

It reads oracle/, so it runs from a checkout of the repository
(chip_smoke.py's `multi` phase calls it on the card, the CPU tests on 4
CPU devices).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORACLE = os.path.join(REPO, "oracle")
BASES = np.frombuffer(b"ACGT", np.uint8)


def _example_batch(s: int, t: int, n: int, m: int):
    """Deterministic example: a query and the engine codes of s random
    segments under t transforms (__graft_entry__._example_batch)."""
    from .. import rules

    rng = np.random.default_rng(0)
    rna = BASES[rng.integers(0, 4, m)]
    scans = (rules.scan_list(0, 0) * ((t + 47) // 48))[:t]
    codes_thresh = np.empty((s, t, n), np.int32)
    codes_ssw = np.empty((s, t, n), np.int32)
    for i in range(s):
        seg = BASES[rng.integers(0, 4, n)]
        s2l = np.stack([rules.make_scan_strings(seg, sc)[0] for sc in scans])
        codes_thresh[i] = rules.THRESH_ENC[s2l]
        codes_ssw[i] = rules.SSW_ENC[s2l]
    return rna, codes_thresh, codes_ssw


def _planted(td: str):
    """The planted-homology input of the round-robin check: 6 records of
    300 nt, each holding the first 100 nt of a 120 nt query."""
    rng = np.random.default_rng(1)
    rna = BASES[rng.integers(0, 4, 120)]
    with open(f"{td}/dna.fa", "w") as f:
        for i in range(6):
            s = BASES[rng.integers(0, 4, 300)]
            lo = int(rng.integers(0, 180))
            s[lo:lo + 100] = rna[:100]  # plant homology so hits exist
            f.write(f">hg19|chr1|{1000 * (i + 1)}-{1000 * (i + 1) + 299}\n"
                    f"{s.tobytes().decode()}\n")
    with open(f"{td}/rna.fa", "w") as f:
        f.write(f">DRYRUN\n{rna.tobytes().decode()}\n")
    return rna


class DryRunError(AssertionError):
    """A check of the dry run failed."""


def _check(cond: bool, what) -> None:
    if not cond:
        raise DryRunError(what)


def dryrun_multichip(devices) -> str:
    """The three checks on engines on `devices`; raises DryRunError on a
    mismatch, returns a one-line summary."""
    from .. import dist, rules
    from ..config import Params
    from ..io import fasta
    from ..kernels import ref
    from ..kernels.engine import TorchScanEngine
    from ..post.output import print_result
    from ..scan import batched
    from . import runner

    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def engines(rna):
        return [TorchScanEngine(rna, device=d) for d in devices]

    # --- 1. the production path: n engines against 1 -----------------------
    with tempfile.TemporaryDirectory() as td:
        rna = _planted(td)
        p = Params(file1path=f"{td}/dna.fa", file2path=f"{td}/rna.fa",
                   c_length=40)
        _, _, _, t_n = batched.scan_file_batched(p, engines(rna),
                                                 batch_pairs=2)
        _, _, _, t_1 = batched.scan_file_batched(
            p, [TorchScanEngine(rna, device=devices[0])], batch_pairs=2)
    _check(len(t_n) == len(t_1) > 0, f"round-robin: {len(t_n)} hits on "
           f"{n} engines, {len(t_1)} on one")
    for a, b in zip(t_n, t_1):
        _check(dataclasses.astuple(a) == dataclasses.astuple(b),
               f"round-robin: {a} on {n} engines, {b} on one")

    # --- 2. the mesh-sharded scan step ------------------------------------
    n_rule = 2 if n % 2 == 0 else 1
    n_seg = n // n_rule
    mesh = dist.make_mesh(n_seg, n_rule, devices)
    s, t = 2 * n_seg, 48
    rna2, codes_thresh, codes_ssw = _example_batch(s, t, 256, 128)
    thresh, colmax = dist.sharded_scan_step(mesh, rna2)(codes_thresh,
                                                        codes_ssw)
    _check(thresh.shape == (s, t) and colmax.shape == (s, t, 256),
           f"sharded step: shapes {thresh.shape}, {colmax.shape}")
    thresh, colmax = thresh.cpu().numpy(), colmax.cpu().numpy()
    for si, ti in [(0, 0), (s - 1, 13), (s // 2, t - 1)]:
        want = ref.sw_max(rules.THRESH_ENC[rna2], codes_thresh[si, ti],
                          rules.THRESH_MAT)
        _check(thresh[si, ti] == want, f"sharded step: thresh[{si}, {ti}] "
               f"{thresh[si, ti]}, sw_max {want}")
        want_cm = ref.sw_colmax(rules.SSW_ENC[rna2], codes_ssw[si, ti],
                                rules.SSW_MAT)
        _check((colmax[si, ti] == want_cm).all(),
               f"sharded step: colmax[{si}, {ti}] differs from sw_colmax")

    # --- 3. the committed golden through both multi-device paths -----------
    golden = os.path.join(ORACLE, "golden", "meg3_sub3")
    files = []
    prev = os.getcwd()
    os.chdir(ORACLE)  # output names embed the -f1 path
    try:
        _, rna3 = fasta.read_rna("MEG3.fa")
        for label, run in (
                ("round-robin", lambda p: batched.scan_file_batched(
                    p, engines(rna3), batch_pairs=4)),
                ("dist-runner", lambda p: runner.scan_distributed(
                    p, engines, batch_pairs=4))):
            with tempfile.TemporaryDirectory() as out:
                p3 = Params(file1path="meg3sub3.fa", file2path="MEG3.fa",
                            outpath=out)
                recs, lnc, _, hits = run(p3)
                r0 = recs[0]
                seq_len = getattr(r0, "seq_len", None) or len(r0.seq)
                print_result(p3, r0.species, lnc, hits, r0.chro_tag,
                             seq_len, r0.start_genome)
                names = sorted(os.listdir(out))
                _check(names == sorted(f for f in os.listdir(golden)
                                       if not f.startswith("stdout")),
                       f"{label}: output files {names}")
                for f in names:
                    with open(os.path.join(out, f), "rb") as fa, \
                            open(os.path.join(golden, f), "rb") as fb:
                        _check(fa.read() == fb.read(),
                               f"{label}: {f} differs from the golden")
                    files.append((label, f))
    finally:
        os.chdir(prev)
    return (f"dryrun_multichip OK: round-robin on {n} engines "
            f"({', '.join(map(str, devices))}) astuple-identical to 1 "
            f"engine ({len(t_1)} hits); mesh "
            f"{dict(zip(dist.AXES, mesh.shape))} thresh "
            f"{tuple(thresh.shape)} colmax {tuple(colmax.shape)}; meg3_sub3 "
            f"through the round-robin and the distributed runner: "
            f"{len(files)} output files byte-identical to "
            "oracle/golden/meg3_sub3")

