"""K1, K5, K7 and K8 (the port's scan_colmax, scan_codes_colmax,
scan_colmax16 and sim_forward kernels) and the window kernels K3, K4 and
K6 (window_fwd, window_general, window_v1, with K4's and K6's routes for
queries past 65,536 rows) of two trees on one card, alternating.

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
(cs, ct); the window passes on the largest forward and reverse dispatch
of MEG3 x meg3sub64's batch (K3 on the forward one, K4 on the reverse
one, K6 on both) and of chip_smoke.long_query() (91,068 nt) x testDNA,
recorded once by a process of this tree (`--record`) into
build/ab_windows.npz: at MEG3's shape also K4's and K6's long-query
routes called directly (this tree: window_general_long, window_v1_long;
before them: the int32 window_general32, and window_keys with the ends
glue v1_ends), and at 91 kb window_general and window_v1, which route
there; with checksums of the ends -- the ptxas registers of the tree's
scan and window kernels, and per window kernel the count and a hash of
its SASS (cuobjdump; a long-form template argument of this tree is
dropped from the name, so the parent's kernels match).  The data come
from one seed, so every round sees the same inputs; the script fails
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


KERNEL = re.compile(
    r"((?:scan(?:_colmax|_codes|16)|window_(?:fwd|pairs))_kernelI\w+?E)E")
WINDOWS = os.path.join(ROOT, "build", "ab_windows.npz")


def _kernel_name(entry: str) -> str | None:
    """A scan or window kernel entry's name without its namespace (which
    holds a hash of its source file) and parameters; this tree's 16-bit
    pair kernels (long form false) drop that template argument, so they
    match the parent's."""
    found = KERNEL.search(entry)
    if not found:
        return None
    return re.sub(r"^(window_pairs_kernel\w*Lb[01]E)Lb0E$", r"\1",
                  found.group(1))


def _registers(build_log: str) -> dict[str, int]:
    """Registers of each scan and window kernel entry in a ptxas report."""
    regs, entry = {}, None
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and entry:
            name = _kernel_name(entry)
            if name:
                regs[name] = int(found.group(1))
            entry = None
    return regs


def _window_sass(lib: str, nvcc: str) -> dict[str, list]:
    """Per window kernel of a built library: [instructions, sha256 of its
    SASS without addresses and encodings] (cuobjdump -sass)."""
    import hashlib

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name, body = {}, None, []

    def close():
        if name:
            out[name] = [len(body), hashlib.sha256(
                "\n".join(body).encode()).hexdigest()[:16]]

    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            close()
            name = _kernel_name(found.group(1))
            name = name if name and name.startswith("window_") else None
            body = []
        elif name:
            instr = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if instr and not instr.startswith("."):
                body.append(instr)
    close()
    return out


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
    """Time this process's kernels, imported from `tree`."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from fasim_tpu_torch.kernels import _build

    assert _build.__file__.startswith(os.path.abspath(tree)), _build.__file__
    dev = torch.device("cuda:0")
    _build.lib()

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
    scan_rounds(np, torch, dev, ms, out)
    window_rounds(np, torch, dev, ms, out)
    out["registers"] = _registers(
        (_build.BUILD_DIR / "build.log").read_text())
    out["sass"] = _window_sass(str(_build.BUILD_DIR / _build.LIB_NAME),
                               _build._nvcc())
    return out


def scan_rounds(np, torch, dev, ms, out) -> None:
    """Time K1, K7, K5 and K8 of this process's tree into out."""
    import inspect

    from fasim_tpu_torch import rules
    from fasim_tpu_torch.kernels.engine import TorchScanEngine
    from fasim_tpu_torch.kernels.scan import (decode_bases, scan_colmax,
                                              scan_colmax16)
    from fasim_tpu_torch.kernels.scan_codes import scan_codes_colmax
    from fasim_tpu_torch.kernels.sim_dev import encode, sim_forward

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


def record_windows() -> None:
    """Record the largest forward and reverse window dispatch of MEG3 x
    meg3sub64's batch and of chip_smoke.long_query() x testDNA (this
    tree's batched driver on the card) into WINDOWS."""
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from fasim_tpu_torch.config import Params
    from fasim_tpu_torch.io import fasta
    from fasim_tpu_torch.kernels.engine import TorchScanEngine
    from fasim_tpu_torch.scan.batched import scan_records

    oracle = os.path.join(ROOT, "oracle")
    _, meg3 = fasta.read_rna(os.path.join(oracle, "MEG3.fa"))
    out = {}
    for label, dna, rna in (("meg3", "meg3sub64.fa", meg3),
                            ("long", "testDNA.fa", chip_smoke.long_query())):
        p = Params(file1path=os.path.join(oracle, dna))
        eng = TorchScanEngine(rna, device="cuda:0")
        with chip_smoke.Smoke.recorded_dispatches() as calls:
            scan_records(p, fasta.read_dna(p.file1path), rna, eng)
        out[f"{label}_rna"] = rna
        for rev in (0, 1):
            _, segs, lens, spec, _, _ = max(
                (c for c in calls if c[4] == rev),
                key=lambda c: len(c[3]["rlens"]))
            out[f"{label}_{rev}_segs"] = np.asarray(
                segs.cpu() if hasattr(segs, "cpu") else segs)
            out[f"{label}_{rev}_lens"] = np.asarray(
                lens.cpu() if hasattr(lens, "cpu") else lens)
            for k, v in spec.items():
                out[f"{label}_{rev}_{k}"] = v
    np.savez(WINDOWS, **out)


def window_rounds(np, torch, dev, ms, out) -> None:
    """Time the window kernels of this process's tree on the dispatches of
    WINDOWS (see the module docstring) into out."""
    from fasim_tpu_torch import rules
    from fasim_tpu_torch.kernels import window as kw
    from fasim_tpu_torch.kernels import window_v1 as kv1
    from fasim_tpu_torch.kernels.engine import SPEC_KEYS, TorchScanEngine

    data = np.load(WINDOWS)
    long_form = hasattr(kw, "window_general_long")
    for label in ("meg3", "long"):
        rna = data[f"{label}_rna"]
        eng = TorchScanEngine(rna, device=dev)
        eng.setup_scans(rules.scan_list(0, 0))
        eng.setup_windows(rna)
        d, m = eng._dev, eng.m
        for rev in (0, 1):
            key = f"{label}_{rev}_"
            spec = {k: data[key + k] for k in SPEC_KEYS}
            segs = torch.from_numpy(data[key + "segs"]).to(dev)
            both = kw.both_strands(segs, torch.from_numpy(
                data[key + "lens"]).to(dev))
            klass = kw.width_class(spec["rlens"])
            parts = []
            for W in kw.WIDTHS:
                sel = np.flatnonzero(klass == W)
                if len(sel):
                    part = {k: torch.from_numpy(np.ascontiguousarray(
                        spec[k][sel], np.int32)).to(dev) for k in SPEC_KEYS}
                    parts.append((kw.gather_window_codes(
                        both, *segs.shape, d["lut_s"], d["is_tr"],
                        part["seg_idx"], part["scan_idx"], part["base"],
                        part["dirn"], part["rlens"], W), part))
            qp = d["qwin_rev" if rev else "qwin_fwd"]
            tab = d["wtab_rev" if rev else "wtab_fwd"]
            qc = eng._qcodes(bool(rev))

            def each(fn, parts=parts):
                return [fn(c, p["offs"], p["terms"], p["rlens"],
                           p["mreals"]) for c, p in parts]

            runs = {}
            if label == "meg3" and not rev:
                runs["k3"] = lambda: each(lambda c, o, t, r, mr: kw.window_fwd(
                    c, qp, tab, r, m, eng.m16))
            if label == "meg3" and rev:
                runs["k4"] = lambda: each(
                    lambda c, o, t, r, mr: kw.window_general(
                        c, qp, o, t, r, mr, m, tab))
                runs["k4_long"] = lambda: each(
                    (lambda c, o, t, r, mr: kw.window_general_long(
                        c, qp, o, t, r, mr, m, tab)) if long_form else
                    (lambda c, o, t, r, mr: kw.window_general32(
                        c, qp, o, t, r, mr, m)))
            if label == "meg3":
                runs[f"k6_{rev}"] = lambda: each(
                    lambda c, o, t, r, mr: kv1.window_v1(
                        c, qc, o, t, r, mr, m, tab))
                runs[f"k6_long_{rev}"] = lambda: each(
                    (lambda c, o, t, r, mr: kv1.window_v1_long(
                        c, qc, o, t, r, mr, m, tab)) if long_form else
                    (lambda c, o, t, r, mr: kv1.v1_ends(
                        c, qc, o, t, r, mr, m, keys=kv1.window_keys)))
            else:
                runs[f"k4_91kb_{rev}"] = lambda: each(
                    lambda c, o, t, r, mr: kw.window_general(
                        c, qp, o, t, r, mr, m, tab))
                runs[f"k6_91kb_{rev}"] = lambda: each(
                    lambda c, o, t, r, mr: kv1.window_v1(
                        c, qc, o, t, r, mr, m, tab))
            for name, fn in runs.items():
                out["ms"][name] = ms(fn, 5)
                ends = torch.cat(fn())
                out["sums"][name] = [int(ends.long().sum()),
                                     int((ends.long() * torch.arange(
                                         1, ends.shape[0] + 1, device=dev)[
                                         :, None]).sum())]


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
    ap.add_argument("--record", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.name)), flush=True)
        return 0
    if a.record:
        record_windows()
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--parent", a.parent, "--record"],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        return 1
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
    # the window kernels both trees build: registers and SASS
    first = {r["tree"]: r for r in rounds}
    if {"parent", "this"} <= first.keys():
        p, t = first["parent"], first["this"]
        for what in ("registers", "sass"):
            same = sorted(k for k in p[what] if k.startswith("window_")
                          and k in t[what])
            print(json.dumps({what: {k: [p[what][k], t[what][k],
                                         p[what][k] == t[what][k]]
                                     for k in same}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
