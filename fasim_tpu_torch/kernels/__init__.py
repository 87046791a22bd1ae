"""The port's kernels: hand-written CUDA for the card (`csrc/`, built by
`_build`), each behind a wrapper that takes its plain PyTorch version for
CPU tensors.

`WRAPPERS` names every kernel wrapper.  Each counts its launches on the
card in its `launches` attribute (`_build.count_launch`); chip_smoke.py
and `fasim_tpu_torch.verify` set the counts to 0 before a run and read
them after it."""

from . import scan, scan_codes, sim_dev, window, window_v1

WRAPPERS = {
    "scan_colmax": scan.scan_colmax,
    "scan_colmax16": scan.scan_colmax16,
    "window_v1": window_v1.window_v1,
    "window_v1_long": window_v1.window_v1_long,
    "window_fwd": window.window_fwd,
    "window_general": window.window_general,
    "window_general_long": window.window_general_long,
    "scan_codes_colmax": scan_codes.scan_codes_colmax,
    "sim_forward": sim_dev.sim_forward,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    """Every wrapper's launch count."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}
