"""GPU parity matrix of the port (counterpart of scripts/verify_tpu.py).

    python -m fasim_tpu_torch.verify [--full] [--json PATH]
    python -m fasim_tpu_torch.verify --prewarm [--json PATH]

Run from the root of a checkout on a machine with a CUDA device; it needs
torch, numpy and nvcc, and nothing of jax.  Two parts:

1. Kernel check (verify_tpu.py:48-107), exact equality: on cuda:0,
   TorchScanEngine(H19) against the NumPy golden engine
   (kernels/batch_np.numpy_engine) on every segment of testDNA with
   rules.scan_list(0, 0), thresholds and column maxima, through the
   per-segment call (K5) and the batch scan (K1, and K7 with the engine's
   scan16 on); then `window_pass` (K4, and K6 with win_v1 on) on 300
   random rows from default_rng(0), forward and reverse, against a CPU
   engine's (the plain version).
2. End-to-end matrix (verify_tpu.py:110-146): every case of the run
   through every route that applies to it (`routes_of`), each run one
   fresh child process `python -m fasim_tpu_torch.verify --one CASE
   --route ROUTE` in a fresh directory holding the inputs
   (ab_cli.run_once), with a fresh, empty FASIM_SPILL_DIR.  The child sets
   every kernel wrapper's `launches` to 0, runs the case through the
   route's driver and prints on stderr one line `FASIM_VERIFY {...}`: its
   wall, every wrapper's launches, prewarm's launches, the escalation
   reruns and the seconds from the first engine's construction to the
   first batch's result on the host.  The parent holds every output file
   and stdout (but "Running time is") byte for byte against the case's
   expected directory (oracle/golden/<case>; oracle/jax_expected/<case>
   for the flag cases, the JAX package's outputs), the exit code, an
   empty spill directory, and the launches: every kernel of the route
   launched, every other wrapper not (`expected_kernels`).

The cases: verify_tpu's FAST list and the flag cases; `--full` adds
every other golden (verify_tpu's FULL list, meg3_sub16, meg3_sub64).
Prints one JSON record per run and, last, one JSON line that sums up the
matrix; exits non-zero on any difference or failure.  `--json PATH`
writes every record there too.

`--prewarm` runs the prewarm readings instead: meg3_full and h19_lg40
on the default route, FASIM_PREWARM=1 and 0 in turns, three runs each,
then one meg3_full pair from a copy of the package with no build/ (the
kernel and native libraries built in the run); each record gives the
wall, the first batch's seconds and the `prewarm_wait` stage.

`--case` and `--route` (repeatable) run only those runs of the matrix,
without the kernel check; `--expected DIR` holds each case against
DIR/<case>.  `--device cpu` (for the tests) runs the children on the CPU
(`--tpu-engine torch`, the plain versions): there no kernel launches, so
the launch check and the kernel check are skipped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import ab_cli

REPO = ab_cli.REPO
ORACLE = ab_cli.ORACLE
PACKAGE = os.path.dirname(os.path.abspath(__file__))

# case -> (DNA, RNA, flags, the directory of oracle/ with its expected
# outputs)
CASES = {
    "h19_lg40": ("testDNA.fa", "H19.fa", ["-lg", "40"], "golden"),
    "h19_default": ("testDNA.fa", "H19.fa", [], "golden"),
    "meg3_sub3": ("meg3sub3.fa", "MEG3.fa", [], "golden"),
    "h19F_trunc": ("testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"], "golden"),
    "neat1t": ("testDNA.fa", "NEAT1t.fa", [], "golden"),
    "meg3_full": ("meg3dna.fa", "MEG3.fa", [], "golden"),
    "neat1": ("testDNA.fa", "NEAT1.fa", [], "golden"),
    "malat1": ("testDNA.fa", "MALAT1.fa", [], "golden"),
    "h19_F": ("testDNA.fa", "H19.fa", ["-F", "-lg", "40"], "golden"),
    "meg3_sub16": ("meg3sub16.fa", "MEG3.fa", [], "golden"),
    "meg3_sub64": ("meg3sub64.fa", "MEG3.fa", [], "golden"),
    # the flag cases (oracle/jax_expected/MANIFEST.json): transform counts
    # 4, 2, 12, 36, 48, 48 and 4; -c 2000 changes the segment width
    "flags_r1": ("testDNA.fa", "H19.fa", ["-lg", "40", "-r", "1"],
                 "jax_expected"),
    "flags_r3_t1": ("testDNA.fa", "H19.fa",
                    ["-lg", "40", "-r", "3", "-t", "1"], "jax_expected"),
    "flags_t1": ("testDNA.fa", "H19.fa", ["-lg", "40", "-t", "1"],
                 "jax_expected"),
    "flags_tm1": ("testDNA.fa", "H19.fa", ["-lg", "40", "-t", "-1"],
                  "jax_expected"),
    "flags_c2000": ("testDNA.fa", "H19.fa",
                    ["-lg", "40", "-c", "2000", "-o", "50"], "jax_expected"),
    "flags_i70": ("testDNA.fa", "H19.fa", ["-lg", "40", "-i", "70", "-S",
                                          "1"], "jax_expected"),
    "flags_F_r2": ("testDNA.fa", "H19.fa", ["-F", "-lg", "40", "-r", "2"],
                   "jax_expected"),
}
FAST = ("h19_lg40", "h19_default", "meg3_sub3", "h19F_trunc", "neat1t")
FLAGS = tuple(c for c in CASES if c.startswith("flags_"))
FULL = tuple(c for c in CASES if c not in FAST + FLAGS)

# route -> (environment, extra CLI flags, driver): "cli" is the port's CLI
# (`cli.main`), "per-segment" scan/pipeline.scan_file and "batched-v1" the
# batched driver with TorchScanEngine(use_v2=False), both through cli.run
ROUTES = {
    "default": ({}, [], "cli"),
    "switched": ({"FASIM_SCAN16": "1", "FASIM_WIN_V1": "1"}, [], "cli"),
    "win_v3_off": ({"FASIM_WIN_V3": "0"}, [], "cli"),
    "stream": ({}, ["--tpu-stream", "on"], "cli"),
    "sim_device": ({"FASIM_SIM_DEVICE": "1"}, [], "cli"),
    "per_segment": ({}, [], "per-segment"),
    "batched_v1": ({}, [], "batched-v1"),
}
# the goldens chip_smoke.py runs through the other drivers
DRIVER_CASES = {"per_segment": ("meg3_sub16",), "batched_v1": ("h19_lg40",)}

K1, K7, K5 = "scan_colmax", "scan_colmax16", "scan_codes_colmax"
K3, K4, K6, K8 = "window_fwd", "window_general", "window_v1", "sim_forward"

PREWARM_CASES = ("meg3_full", "h19_lg40")
PREWARM_REPS = 3


def exact_sim(case: str) -> bool:
    return "-F" in CASES[case][2]


def routes_of(case: str) -> list[str]:
    """The routes a case runs through: default, the switches and the
    streaming driver; the forward specs on K4 (fastSIM) or the forward
    scan on K8 (-F); the other drivers where chip_smoke runs them."""
    out = ["default", "switched", "stream",
           "sim_device" if exact_sim(case) else "win_v3_off"]
    return out + [r for r, cases in DRIVER_CASES.items() if case in cases]


def expected_kernels(case: str, route: str, escalations: int) -> set[str]:
    """The kernels a run of `case` through `route` launches; it launches no
    other wrapper (no golden or flag query reaches the long forms).  K1
    also runs under FASIM_SCAN16=1 when the batch escalates: the
    full-prefix rerun takes it (kernels/engine.py:scan_segments)."""
    if route == "per_segment":
        return {K5}
    if route == "batched_v1":
        return {K5, K3, K4}
    if route == "switched":
        scan = {K7} | ({K1} if escalations else set())
        return scan if exact_sim(case) else scan | {K6}
    if exact_sim(case):
        return {K1, K8} if route == "sim_device" else {K1}
    return {K1, K4} if route == "win_v3_off" else {K1, K3, K4}


def expected_dir(case: str) -> str:
    return os.path.join(ORACLE, CASES[case][3], case)


# -- the child --------------------------------------------------------------

@contextlib.contextmanager
def instrumented(marks: dict):
    """In the block, mark in `marks` the start of the first TorchScanEngine
    construction ("engine") and the moment the first batch's result is on
    the host ("result": the batched driver's `_process_batch` returns, or
    the per-segment engine call), and count the escalation reruns
    (`scan_segments(full_prefix=True)`)."""
    from .kernels.engine import TorchScanEngine
    from .scan import batched

    saved = {"init": TorchScanEngine.__init__,
             "scan": TorchScanEngine.scan_segments,
             "call": TorchScanEngine.__call__}
    process = batched._process_batch
    lock = threading.Lock()
    marks["escalations"] = 0

    def mark(key):
        with lock:
            marks.setdefault(key, time.perf_counter())

    def init(self, *args, **kw):
        mark("engine")
        saved["init"](self, *args, **kw)

    def scan(self, *args, **kw):
        if kw.get("full_prefix"):
            with lock:
                marks["escalations"] += 1
        return saved["scan"](self, *args, **kw)

    def call(self, *args, **kw):
        out = saved["call"](self, *args, **kw)
        mark("result")
        return out

    def process_batch(*args, **kw):
        out = process(*args, **kw)
        mark("result")
        return out

    TorchScanEngine.__init__ = init
    TorchScanEngine.scan_segments = scan
    TorchScanEngine.__call__ = call
    batched._process_batch = process_batch
    try:
        yield
    finally:
        TorchScanEngine.__init__ = saved["init"]
        TorchScanEngine.scan_segments = saved["scan"]
        TorchScanEngine.__call__ = saved["call"]
        batched._process_batch = process


def scan_for(driver: str, device: str):
    """cli.run's scan callable for a driver other than the CLI's own."""
    from .kernels.engine import TorchScanEngine
    from .scan.batched import scan_file_batched
    from .scan.pipeline import scan_file

    if driver == "per-segment":
        return lambda p, rna: scan_file(
            p, engine=TorchScanEngine(rna, device=device))
    if driver == "batched-v1":
        return lambda p, rna: scan_file_batched(
            p, TorchScanEngine(rna, device=device, use_v2=False))
    raise ValueError(f"unknown driver {driver!r}")


def child(case: str, route: str, device: str) -> int:
    """One run of the matrix in this process (the working directory holds
    the inputs and out/); the route's environment is the caller's."""
    import torch

    from . import cli
    from .kernels import read_launches, reset_launches
    from .scan.prewarm import prewarm_engines

    f1, f2, flags, _ = CASES[case]
    _, extra, driver = ROUTES[route]
    cuda = device != "cpu"
    argv = ["-f1", f1, "-f2", f2, "-O", "out/", "--tpu-stdout-compat",
            "true", "--tpu-profile", "true", "--tpu-engine",
            "cuda" if cuda else "torch", *flags, *extra]
    marks: dict = {}
    reset_launches()
    prewarm_engines.launches = 0
    with instrumented(marks):
        t0 = time.perf_counter()
        if driver == "cli":
            rc = cli.main(argv)
        else:
            p, tpu = cli.parse_args(argv)
            dev = "cuda:0" if cuda else "cpu"
            rc = cli.run(p, tpu, scan_for(driver, dev))
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    first = (marks["result"] - marks["engine"]
             if "result" in marks and "engine" in marks else None)
    record = {"wall": wall, "first_batch_s": first,
              "launches": read_launches(),
              "prewarm_launches": prewarm_engines.launches,
              "escalations": marks["escalations"],
              "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    sys.stdout.flush()
    print("FASIM_VERIFY " + json.dumps(record), file=sys.stderr, flush=True)
    return rc


# -- the parent -------------------------------------------------------------

def run_case(case: str, route: str, device: str = "cuda",
             expected: str | None = None, env: dict | None = None,
             checkout: str = REPO) -> dict:
    """One run of the matrix in a child process: its record, with "ok"
    and, when not ok, "why"."""
    f1, f2, _, _ = CASES[case]
    expected = expected or expected_dir(case)
    why = []
    with tempfile.TemporaryDirectory() as spill:
        run_env = dict(ROUTES[route][0], **(env or {}),
                       FASIM_SPILL_DIR=spill)
        res = ab_cli.run_once(checkout, (f1, f2), expected,
                              ["--one", case, "--route", route, "--device",
                               device], run_env,
                              module="fasim_tpu_torch.verify")
        left = os.listdir(spill)
    rec = {"case": case, "route": route, "env": env or {},
           "identical": not res["differ"], "rc": res["rc"],
           "differ": res["differ"]}
    if res["rc"] != 0:
        why.append(f"exit {res['rc']}: {res['stderr'][-2000:]}")
    if res["differ"]:
        why.append(f"differs from {os.path.relpath(expected, REPO)}: "
                   f"{res['differ']}")
    if left:
        why.append(f"spill files left behind: {left}")
    lines = [ln for ln in res["stderr"].splitlines()
             if ln.startswith("FASIM_VERIFY ")]
    if lines:
        rec.update(json.loads(lines[-1][len("FASIM_VERIFY "):]))
    elif res["rc"] == 0:
        why.append("the child printed no FASIM_VERIFY line")
    rec["stages"] = res["profile"]
    if lines and device != "cpu":
        on = expected_kernels(case, route, rec["escalations"])
        for name, n in rec["launches"].items():
            if name in on and n == 0:
                why.append(f"{name} was never launched")
            elif name not in on and n:
                why.append(f"{name} was launched {n} times")
    rec["ok"] = not why
    if why:
        rec["why"] = why
    return rec


def kernel_check(dev: str = "cuda:0") -> list[dict]:
    """Part 1: the engine's kernels against the NumPy golden engine and
    the window kernels against the plain version, exact."""
    from . import rules
    from .io import fasta
    from .kernels.batch_np import numpy_engine
    from .kernels.engine import TorchScanEngine
    from .kernels.scan_codes import apply_byte_break

    _, rna = fasta.read_rna(os.path.join(ORACLE, "H19.fa"))
    recs = fasta.read_dna(os.path.join(ORACLE, "testDNA.fa"))
    segs, _ = fasta.cut_sequence(recs[0].seq, 5000, 100)
    scans = rules.scan_list(0, 0)
    eng = TorchScanEngine(rna, device=dev)
    eng16 = TorchScanEngine(rna, device=dev)
    eng16.scan16 = True
    for e in (eng, eng16):
        e.setup_scans(scans)
    n_pad = (max(len(s) for s in segs) + 127) // 128 * 128
    batch = np.zeros((len(segs), n_pad), np.uint8)
    lengths = np.array([len(s) for s in segs], np.int32)
    for i, seg in enumerate(segs):
        batch[i, :len(seg)] = seg
    scanned = {}
    for name, e in ((K1, eng), (K7, eng16)):
        thresh, cm = e.scan_segments(batch, lengths)
        scanned[name] = (thresh.cpu().numpy(), cm.cpu().numpy())
    out = []
    for i, seg in enumerate(segs):
        s2l = [rules.make_scan_strings(seg, s)[0] for s in scans]
        want_t, want_cm = numpy_engine(rna, s2l)
        got_t, got_cm = eng(rna, s2l)
        out.append({"check": f"scan {K5} segment {i} (len {len(seg)})",
                    "identical": bool(np.array_equal(got_t, want_t)
                                      and np.array_equal(got_cm, want_cm))})
        for name, (thresh, cm) in scanned.items():
            got = apply_byte_break(cm[i, :, :len(seg)].astype(np.int32))
            out.append({"check": f"scan {name} segment {i}",
                        "identical": bool(
                            np.array_equal(thresh[i], want_t)
                            and np.array_equal(got, want_cm))})
    rng = np.random.default_rng(0)
    cpu = TorchScanEngine(rna, device="cpu")
    for e in (eng, cpu):
        e.setup_scans(scans)
        e.setup_windows(rna)
    rows = 300
    codes = rng.integers(0, 5, (rows, 256)).astype(np.uint8)
    rlens = rng.integers(8, 197, rows).astype(np.int32)
    offs = rng.integers(0, len(rna) // 2, rows).astype(np.int32)
    terms = np.where(rng.random(rows) < 0.5, -1,
                     rng.integers(5, 90, rows)).astype(np.int32)
    mreals = (len(rna) + rng.integers(0, 16, rows)).astype(np.int32)
    for rev in (False, True):
        want = cpu.window_pass(codes, offs, terms, rlens, mreals, rev=rev)
        for name, v1 in ((K4, False), (K6, True)):
            eng.win_v1 = v1
            got = eng.window_pass(codes, offs, terms, rlens, mreals, rev=rev)
            out.append({"check": f"window {name} rev={rev}",
                        "identical": bool(np.array_equal(got, want))})
    return out


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def matrix_runs(cases) -> list[tuple[str, str]]:
    return [(case, route) for case in cases for route in routes_of(case)]


def prewarm_runs() -> list[tuple[str, str, str, bool]]:
    """(case, FASIM_PREWARM, checkout kind) of the prewarm readings: each
    case PREWARM_REPS times with either flag, in turns (1 0 0 1 1 0), then
    one meg3_full pair from a package copy with no build/ (cold)."""
    runs = []
    for case in PREWARM_CASES:
        for rep in range(PREWARM_REPS):
            order = ("1", "0") if rep % 2 == 0 else ("0", "1")
            runs += [(case, flag, False) for flag in order]
    return runs + [("meg3_full", flag, True) for flag in ("1", "0")]


def run_prewarm(case: str, flag: str, cold: bool, device: str) -> dict:
    env = {"FASIM_PREWARM": flag}
    if not cold:
        return run_case(case, "default", device, env=env)
    with tempfile.TemporaryDirectory() as checkout:
        shutil.copytree(PACKAGE, os.path.join(checkout, "fasim_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        rec = run_case(case, "default", device, env=env, checkout=checkout)
    rec["cold"] = True
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="every golden, not only verify_tpu's FAST ones")
    ap.add_argument("--prewarm", action="store_true",
                    help="the prewarm readings instead of the matrix")
    ap.add_argument("--json", help="also write every record to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the children on the plain versions (tests)")
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="run only this case (repeatable)")
    ap.add_argument("--route", action="append", choices=sorted(ROUTES),
                    help="run only this route (repeatable)")
    ap.add_argument("--expected",
                    help="hold each case against DIR/<case> instead")
    ap.add_argument("--one", choices=sorted(CASES), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        [route] = args.route
        return child(args.one, route, args.device)
    cuda = args.device == "cuda"
    if cuda:
        import torch

        if not torch.cuda.is_available():
            print("verify: no CUDA device (torch.cuda.is_available() is "
                  "false)", file=sys.stderr)
            return 2
    smi = card() if cuda else "cpu"
    records, ok = [], True
    if args.prewarm:
        for case, flag, cold in prewarm_runs():
            rec = run_prewarm(case, flag, cold, args.device)
            rec["card"] = smi
            records.append(rec)
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
    else:
        if cuda and not args.case:
            for rec in kernel_check():
                rec["card"] = smi
                records.append(rec)
                ok &= rec["identical"]
                print(json.dumps(rec), flush=True)
        cases = args.case or FAST + FLAGS + (FULL if args.full else ())
        for case, route in matrix_runs(cases):
            if args.route and route not in args.route:
                continue
            expected = (os.path.join(args.expected, case) if args.expected
                        else None)
            rec = run_case(case, route, args.device, expected)
            rec["card"] = smi
            records.append(rec)
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    runs = [r for r in records if "case" in r]
    print(json.dumps({"ok": bool(ok), "card": smi, "runs": len(runs),
                      "identical": sum(r["identical"] for r in runs),
                      "kernel_checks": len(records) - len(runs),
                      "failed": [f"{r['case']}/{r['route']}" for r in runs
                                 if not r["ok"]]
                      + [r["check"] for r in records
                         if "check" in r and not r["identical"]]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
