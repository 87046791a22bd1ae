"""A/B of the port's CLI between two checkouts, one process per run.

    python -m fasim_tpu_torch.ab_cli --other DIR [--case meg3_full ...]

Run from the root of a checkout ("this"); DIR is another checkout of the
repository ("other", e.g. a parent commit unpacked with `git archive`).
For each case the runs go other, this, this, other: `python -m
fasim_tpu_torch.cli` with that checkout on PYTHONPATH, on the card
(`--tpu-engine cuda`), with `--tpu-profile true --tpu-stdout-compat
true`, in a fresh directory holding the inputs.
Each run's output files and stdout (except "Running time is") are held
against this checkout's oracle/golden/<case>.  Prints one line per run
(wall and the main stages of FASIM_PROFILE) and, last, one JSON object of
every run; exits non-zero when a run fails or differs from its golden.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "oracle")
# golden case -> (DNA, RNA, extra flags)
CASES = {
    "h19_default": ("testDNA.fa", "H19.fa", []),
    "meg3_full": ("meg3dna.fa", "MEG3.fa", []),
}
STAGES = ("cand_finalize_busy", "host_candidate_wait", "cand_fwd_dev",
          "device_wait")


def expected_stdout(expected: str) -> str:
    """The one `stdout*` file of an expected-output directory (a golden's
    is stdout.txt or stdout_<case>.txt)."""
    [name] = [f for f in os.listdir(expected) if f.startswith("stdout")]
    return os.path.join(expected, name)


def stdout_lines(text: str) -> list[str]:
    """A run's stdout lines but the `Running time is` one."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("Running time is")]


def run_once(checkout: str, inputs: tuple[str, str], expected: str,
             argv: list[str], env: dict | None = None,
             module: str = "fasim_tpu_torch.cli") -> dict:
    """`python -m <module> <argv>` in a fresh directory holding the two
    oracle/ inputs and an empty out/, with `checkout` on PYTHONPATH and
    `env` over this process's environment.  Every file of out/ and the
    stdout (but "Running time is") are held against the directory
    `expected`.  Returns {"ok", "rc", "differ" (names: files and
    "stdout"), "profile" (FASIM_PROFILE), "stderr"}."""
    env = dict(os.environ, **(env or {}),
               PYTHONPATH=os.path.abspath(checkout))
    with tempfile.TemporaryDirectory() as tmp:
        for name in inputs:
            shutil.copy(os.path.join(ORACLE, name), tmp)
        os.mkdir(os.path.join(tmp, "out"))
        r = subprocess.run([sys.executable, "-m", module, *argv], cwd=tmp,
                           env=env, capture_output=True, text=True,
                           timeout=1800)
        produced = sorted(os.listdir(os.path.join(tmp, "out")))
        stdout = expected_stdout(expected)
        wanted = sorted(f for f in os.listdir(expected)
                        if f != os.path.basename(stdout))
        differ = [f for f in wanted if f not in produced or not
                  filecmp.cmp(os.path.join(tmp, "out", f),
                              os.path.join(expected, f), shallow=False)]
        differ += [f for f in produced if f not in wanted]
    with open(stdout) as f:
        if stdout_lines(r.stdout) != stdout_lines(f.read()):
            differ.append("stdout")
    prof = {}
    for line in r.stderr.splitlines():
        if line.startswith("FASIM_PROFILE "):
            prof = json.loads(line[len("FASIM_PROFILE "):])
    return {"ok": r.returncode == 0 and not differ, "rc": r.returncode,
            "differ": differ, "profile": prof, "stderr": r.stderr}


def run_case(checkout: str, case: str) -> dict:
    """One CLI run of a golden case on the card (--tpu-engine cuda)."""
    f1, f2, extra = CASES[case]
    res = run_once(checkout, (f1, f2), os.path.join(ORACLE, "golden", case),
                   ["-f1", f1, "-f2", f2, "-O", "out/",
                    "--tpu-stdout-compat", "true", "--tpu-profile", "true",
                    "--tpu-engine", "cuda", *extra])
    if res["rc"] != 0:
        res["why"] = f"exit {res['rc']}: {res['stderr'][-2000:]}"
    del res["stderr"]
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="golden case (repeatable; default meg3_full)")
    args = ap.parse_args(argv)
    runs = []
    for case in args.case or ["meg3_full"]:
        for who, checkout in (("other", args.other), ("this", REPO),
                              ("this", REPO), ("other", args.other)):
            res = run_case(checkout, case)
            res.update(case=case, checkout=who)
            runs.append(res)
            prof = res.get("profile", {})
            stages = " ".join(f"{k} {prof[k]}" for k in STAGES if k in prof)
            print(f"{case} {who}: "
                  f"{'byte-identical' if res['ok'] else 'DIFFERS'} "
                  f"{res.get('why') or res['differ']} wall "
                  f"{prof.get('wall', 'not measured')} s; {stages}",
                  flush=True)
    print(json.dumps(runs))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
