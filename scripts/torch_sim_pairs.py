"""Where h19_F's `-F` time goes, pair by pair, on one CUDA card.

    python3 scripts/torch_sim_pairs.py

h19_F is H19 (2,812 nt) x testDNA.fa (one 4,366 nt segment), `-F -lg
40`: 48 (segment, transform) pairs, each an exact SIM run.  The script
takes the segment's thresholds from K1 (`TorchScanEngine.scan_segments`,
min_score = int(gm * 0.8), as the drivers do), then runs the 48 pairs on
a pool of one thread a core, as scan/batched.py does, twice:

  * host: `native.sim_scan` (the host's own forward scan, node list,
    tracebacks);
  * device: K8 (`sim_forward_cells` in the driver's groups of 2) and
    `native.sim_scan_replay` of its cells.

It prints each mode's wall (host clock), each pair's seconds in its
thread sorted from the largest, their sum, and the K8 and compaction
share, and fails unless both modes give the same rows.  Then the card's
name and power limit and one JSON line of the numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from fasim_tpu_torch import native, rules
    from fasim_tpu_torch.config import Params
    from fasim_tpu_torch.io import fasta
    from fasim_tpu_torch.kernels.engine import TorchScanEngine
    from fasim_tpu_torch.kernels.sim_dev import sim_forward_cells

    if not torch.cuda.is_available():
        print("torch_sim_pairs: no CUDA device", file=sys.stderr)
        return 2
    oracle = os.path.join(ROOT, "oracle")
    p = Params()
    _, rna = fasta.read_rna(os.path.join(oracle, "H19.fa"))
    [rec] = fasta.read_dna(os.path.join(oracle, "testDNA.fa"))
    [seg], _ = fasta.cut_sequence(rec.seq, p.cut_length, p.overlap_length)
    scans = rules.scan_list(p.rule, p.strand)
    eng = TorchScanEngine(rna, device="cuda:0")
    eng.setup_scans(scans)
    segs = np.zeros((1, (len(seg) + 127) // 128 * 128), np.uint8)
    segs[0, :len(seg)] = seg
    gm = eng.scan_segments(segs, np.array([len(seg)], np.int32))[0]
    mins = [int(int(g) * 0.8) for g in gm.cpu().numpy()[0]]
    pairs = [rules.make_scan_strings(seg, sc) for sc in scans]

    def args(k):
        sc = scans[k]
        return (rna.tobytes(), pairs[k][0].tobytes(), pairs[k][1].tobytes(),
                0, mins[k], sc["strand"], sc["para"], p.nt_min, p.nt_max,
                p.penalty_t, p.penalty_c)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    sim_forward_cells(rna, [pairs[0][0]], mins[:1], "cuda:0")  # warm-up
    t0 = time.perf_counter()
    host = list(pool.map(lambda k: timed(native.sim_scan, *args(k)),
                         range(len(scans))))
    host_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    futs, dev_s = [], 0.0
    for lo in range(0, len(scans), 2):
        grp = list(range(lo, min(lo + 2, len(scans))))
        t1 = time.perf_counter()
        cells = sim_forward_cells(rna, [pairs[k][0] for k in grp],
                                  [mins[k] for k in grp], "cuda:0")
        dev_s += time.perf_counter() - t1
        futs += [pool.submit(timed, native.sim_scan_replay, *args(k), c)
                 for k, c in zip(grp, cells)]
    replay = [f.result() for f in futs]
    dev_wall = time.perf_counter() - t0
    pool.shutdown()
    if [r for r, _ in host] != [r for r, _ in replay]:
        print("torch_sim_pairs: the replay's rows differ from the host's",
              file=sys.stderr)
        return 1
    host_s = [t for _, t in host]
    rep_s = [t for _, t in replay]

    def top(ts):
        return ", ".join(f"{t:.3f}" for t in sorted(ts, reverse=True)[:8])

    print(f"host SIM: wall {host_wall:.3f} s, pairs {sum(host_s):.3f} "
          f"thread-s, largest {top(host_s)}")
    print(f"device forward scan: wall {dev_wall:.3f} s, K8 + compaction + "
          f"copy {dev_s:.3f} s on one thread, replays {sum(rep_s):.3f} "
          f"thread-s, largest {top(rep_s)}")
    print(f"rows {sum(len(r) for r, _ in host)}, equal; min scores {mins}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"host_wall_s": host_wall, "host_pair_s": host_s,
                      "device_wall_s": dev_wall, "device_scan_s": dev_s,
                      "replay_pair_s": rep_s, "cores": os.cpu_count(),
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
