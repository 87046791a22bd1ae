"""The scan cells the engine asked its kernels to sweep over the cells the
window's scans need: (n_scan_cells + n_scan_cells_prewarm) from the
program's counters over the window (each pass S segments x T transforms
x the query rounded up to 16 rows x the batch's padded columns: the ssw
pass, a threshold pass where not fused, the escalation rerun; prewarm's
scan apart) over transforms x query length x DNA bases scanned, the
cells portbench.yardstick counts.  1.0 is no waste; padding to the
batch's longest segment, escalation reruns and prewarm raise it.  None
where the program does not count them.  Engine layer; moves
device_s_per_mbp."""


def read(rec: dict):
    stages = rec.get("stages") or {}
    if "n_scan_cells" not in stages:
        return None
    need = rec["transforms"] * rec["query_len"] * rec["scanned"]
    if need <= 0:
        return None
    swept = stages["n_scan_cells"] + stages.get("n_scan_cells_prewarm", 0)
    return swept / need
