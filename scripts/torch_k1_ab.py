"""K1, K5, K7 and K8 (the port's scan_colmax, scan_codes_colmax,
scan_colmax16 and sim_forward kernels) of two trees on one card,
alternating.

    python3 scripts/torch_k1_ab.py --parent DIR [--min-blocks N]

DIR holds another checkout of the repo, e.g. the parent commit unpacked
with `git archive` into build/.  Each round runs in a process of its own,
in the order parent, this tree, this tree, parent, and prints one JSON line:
the milliseconds (CUDA events, mean of a few runs after a warm-up) of the
passes chip_smoke.py phase 5 times -- K1's ssw pass of a 64-segment MEG3
batch (S=64, T=48, N=5,120, m=1,582; column maxima and thresholds), its
threshold-alphabet pass of that batch (thresholds only) and its ssw pass
at NEAT1 length (m=22,767); K5's ssw and threshold passes at the
per-segment shape (48 code rows x 5,000, m=1,582), its ssw pass on a
packed batch (64 x 48 x 5,120) and on the per-segment rows at NEAT1
length; K7's ssw and threshold passes of K1's MEG3 batch and its ssw pass
at NEAT1 length; K8 at its own launch plan on h19_F's group (H19 x
testDNA's segment, the first two transforms: T = 2, m = 2,812, N = 4,366)
and on a NEAT1-length pair (NEAT1 x a 5,000-nt reference with a planted,
10% mutated piece of the query: T = 1, m = 22,767), with checksums of its
(cs, ct) -- and the ptxas registers of the tree's scan kernels.  The data
come from one seed, so every round sees the same inputs; the script fails
unless every round's outputs are equal.

--min-blocks N also builds a copy of this tree whose K1 has a launch bound
of N one-warp blocks an SM in place of its own (csrc/scan.cu kMinBlocks)
and times it against this tree in the order this, copy, copy, this.

Needs one CUDA card and nvcc; prints a summary line per tree last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
MEG3_M, NEAT1_M = 1582, 22767
S, N, SEG_LEN = 64, 5120, 5000


def _registers(build_log: str) -> dict[str, int]:
    """Registers of each scan_colmax and scan_codes kernel entry in a ptxas
    report."""
    regs, entry = {}, None
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and entry:
            name = re.search(
                r"(scan(?:_colmax|_codes|16)_kernelI\w+?E)E", entry)
            if name:
                regs[name.group(1)] = int(found.group(1))
            entry = None
    return regs


def k8_cases(np) -> list:
    """K8's cases (label, query, refs, reps): h19_F's group and a
    NEAT1-length pair, read from this tree's oracle/ inputs."""
    from fasim_tpu_torch import rules
    from fasim_tpu_torch.config import Params
    from fasim_tpu_torch.io import fasta

    oracle = os.path.join(ROOT, "oracle")
    p = Params()
    _, h19 = fasta.read_rna(os.path.join(oracle, "H19.fa"))
    [rec] = fasta.read_dna(os.path.join(oracle, "testDNA.fa"))
    [seg], _ = fasta.cut_sequence(rec.seq, p.cut_length, p.overlap_length)
    scans = rules.scan_list(p.rule, p.strand)
    h19_refs = [rules.make_scan_strings(seg, sc)[0] for sc in scans[:2]]
    _, neat1 = fasta.read_rna(os.path.join(oracle, "NEAT1.fa"))
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[rng.integers(0, 4, 5000)].copy()
    piece = neat1[:3000].copy()
    muts = rng.random(len(piece)) < 0.1
    piece[muts] = bases[rng.integers(0, 4, int(muts.sum()))]
    ref[1000:4000] = piece
    return [("k8_h19F_group", h19, h19_refs, 20),
            ("k8_neat1", neat1, [ref], 5)]


def worker(tree: str, name: str) -> dict:
    """Time this process's K1, imported from `tree`."""
    sys.path.insert(0, tree)
    import inspect

    import numpy as np
    import torch

    from fasim_tpu_torch import rules
    from fasim_tpu_torch.kernels import _build
    from fasim_tpu_torch.kernels.engine import TorchScanEngine
    from fasim_tpu_torch.kernels.scan import (decode_bases, scan_colmax,
                                              scan_colmax16)
    from fasim_tpu_torch.kernels.scan_codes import scan_codes_colmax
    from fasim_tpu_torch.kernels.sim_dev import encode, sim_forward

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    dev = torch.device("cuda:0")
    _build.lib()
    rng = np.random.default_rng(SEED)

    def dna(n):
        return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()

    segs = np.zeros((S, N), np.uint8)
    for i in range(S):
        segs[i, :SEG_LEN] = dna(SEG_LEN)
    lens = np.full(S, SEG_LEN, np.int32)
    bases, bases_rev = decode_bases(torch.from_numpy(segs).to(dev),
                                    torch.from_numpy(lens).to(dev))
    takes_tab = "tab" in inspect.signature(scan_colmax).parameters

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": name, "ms": {}, "sums": {}}
    for label, m, alpha, want_cm, reps in (
            ("ssw", MEG3_M, "ssw", True, 5),
            ("thresh", MEG3_M, "thresh", False, 5),
            ("neat1", NEAT1_M, "ssw", True, 2)):
        eng = TorchScanEngine(dna(m), device=dev)
        eng.setup_scans(rules.scan_list(0, 0))
        d = eng._dev
        args = [bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
                d[f"qp2_{alpha}"]]
        if takes_tab:
            args.append(d[f"stab_{alpha}"])
        args += [eng.m16, alpha == "thresh"]

        def run():
            return scan_colmax(*args, want_cm=want_cm)

        out["ms"][label] = ms(run, reps)
        cm, gm = run()
        out["sums"][label] = [int(gm.sum()), int(gm.max()),
                              None if cm is None else int(cm.sum())]
    k7_tab = "tab" in inspect.signature(scan_colmax16).parameters
    for label, m, alpha, want_cm, reps in (
            ("k7_ssw", MEG3_M, "ssw", True, 5),
            ("k7_thresh", MEG3_M, "thresh", False, 5),
            ("k7_neat1", NEAT1_M, "ssw", True, 2)):
        eng = TorchScanEngine(dna(m), device=dev)
        eng.setup_scans(rules.scan_list(0, 0))
        d = eng._dev
        args = [bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
                d[f"qp2_{alpha}"]]
        if k7_tab:
            args.append(d[f"stab16_{alpha}"])
        args += [eng.m16, alpha == "thresh"]

        def run7():
            return scan_colmax16(*args, want_cm=want_cm)

        out["ms"][label] = ms(run7, reps)
        cm, gm = run7()
        out["sums"][label] = [int(gm.sum()), int(gm.max()),
                              None if cm is None else int(cm.sum())]
    k5_tab = "tab" in inspect.signature(scan_codes_colmax).parameters
    for label, m, alpha, shape, reps in (
            ("k5_ssw", MEG3_M, "ssw", (1, 48, SEG_LEN), 5),
            ("k5_thresh", MEG3_M, "thresh", (1, 48, SEG_LEN), 5),
            ("k5_packed", MEG3_M, "ssw", (S, 48, N), 3),
            ("k5_neat1", NEAT1_M, "ssw", (1, 48, SEG_LEN), 2)):
        eng = TorchScanEngine(dna(m), device=dev)
        codes = torch.from_numpy(rng.integers(0, 4, shape).astype(
            np.uint8)).to(dev)  # A C G T in either alphabet
        d = eng._dev
        args = [codes, d[f"qprops_{alpha}"]]
        if k5_tab:
            args.append(d[f"ctab_{alpha}"])
        args += [eng.m16, alpha]

        def run5():
            return scan_codes_colmax(*args)

        out["ms"][label] = ms(run5, reps)
        cm = run5()
        out["sums"][label] = [int(cm.sum()), int(cm.max())]
    for label, rna, refs, reps in k8_cases(np):
        q, r = encode(rna, refs)
        qd = torch.from_numpy(q).to(dev)
        rd = torch.from_numpy(r).to(dev)
        m = len(rna)
        out["ms"][label] = ms(lambda: sim_forward(qd, rd, m), reps)
        cs, ct = sim_forward(qd, rd, m)
        out["sums"][label] = [int(cs.long().sum()), int(ct.long().sum())]
    out["registers"] = _registers(
        (_build.BUILD_DIR / "build.log").read_text())
    return out


def min_blocks_copy(n: int) -> str:
    """A copy of this tree's package under build/ with K1's launch bound
    set to n blocks an SM."""
    dst = os.path.join(ROOT, "build", f"k1_min_blocks_{n}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "fasim_tpu_torch"),
                    os.path.join(dst, "fasim_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "fasim_tpu_torch", "csrc", "scan.cu")
    text = open(src).read()
    text, hits = re.subn(r"constexpr int kMinBlocks = \d+;",
                         f"constexpr int kMinBlocks = {n};", text)
    assert hits == 1, "csrc/scan.cu: no kMinBlocks constant"
    open(src, "w").write(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--min-blocks", type=int)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.name)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    trees = {"parent": os.path.abspath(a.parent), "this": ROOT}
    order = ["parent", "this", "this", "parent"]
    if a.min_blocks:
        name = f"min_blocks_{a.min_blocks}"
        trees[name] = min_blocks_copy(a.min_blocks)
        order += ["this", name, name, "this"]
    rounds = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", a.parent,
             "--worker", trees[name], "--name", name],
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rounds.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rounds[-1]), flush=True)
    for r in rounds[1:]:
        if r["sums"] != rounds[0]["sums"]:
            print(f"{r['tree']}: outputs {r['sums']} != {rounds[0]['sums']}",
                  file=sys.stderr)
            return 1
    print("outputs equal in every round")
    for name in dict.fromkeys(order):
        times = [r["ms"] for r in rounds if r["tree"] == name]
        print(json.dumps({"tree": name, "ms": {
            k: [round(t[k], 3) for t in times] for k in times[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
