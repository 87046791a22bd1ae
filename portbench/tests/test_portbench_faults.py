"""A run with the timed path broken underneath comes out not correct:
the harness drives cli.main on the port's CPU engine past its look for
a GPU, with one fault planted in the program each time, through the
batched driver and through the streaming driver, whose store has faults
of its own.  The cells run on one GPU and exchange nothing between
chips, so that fault has no place here."""

import copy

import numpy as np
import pytest

from .conftest import run_tiny


def _state_unchanged(monkeypatch):
    """The scan step hands back its starting state: every threshold and
    column maximum 0."""
    from fasim_tpu_torch.kernels import engine

    orig = engine.TorchScanEngine.scan_segments

    def scan(self, *args, **kwargs):
        gm, cm = orig(self, *args, **kwargs)
        return gm * 0, cm * 0

    monkeypatch.setattr(engine.TorchScanEngine, "scan_segments", scan)


def _half_batch(monkeypatch):
    """Half of each batch's segments left out of the candidate stage."""
    from concurrent.futures import Future

    from fasim_tpu_torch.scan import batched

    orig = batched.candidate_stage_batch

    def stage(*args, **kwargs):
        outs = orig(*args, **kwargs)
        for k in range(1, len(outs), 2):
            fut = Future()
            fut.set_result([])
            outs[k] = (outs[k][0], fut)
        return outs

    monkeypatch.setattr(batched, "candidate_stage_batch", stage)


def _answer_altered(monkeypatch):
    """One triplex's score altered where the finalize produces it."""
    from fasim_tpu_torch import native
    from fasim_tpu_torch.scan import candidates

    orig = native.finalize_pair

    def finalize(*args, **kwargs):
        rows = orig(*args, **kwargs)
        if rows:
            r = list(rows[0])
            r[5] = np.float32(r[5]) + 1
            rows = [tuple(r), *rows[1:]]
        return rows

    monkeypatch.setattr(candidates.native, "finalize_pair", finalize)


def _output_altered(monkeypatch):
    """The output stage writes the rows' numbers wrong (the list's
    writer and the streamed store's)."""
    from fasim_tpu_torch.post import output, store

    orig = output._fmt_f

    def fmt(v):
        return orig(v) + "1"

    monkeypatch.setattr(output, "_fmt_f", fmt)
    monkeypatch.setattr(store, "_fmt_f", fmt)


def _store_record_dropped(monkeypatch):
    """A streamed job's store leaves out the hits of one record: the
    first record with hits of each job."""
    from fasim_tpu_torch.post import store

    orig = store.TriplexStore.add_record

    def add(self, bucket, chro, hits):
        if hits and not getattr(self, "dropped", False):
            self.dropped = True
            hits = []
        return orig(self, bucket, chro, hits)

    monkeypatch.setattr(store.TriplexStore, "add_record", add)


def _spilled_string_altered(monkeypatch):
    """A streamed job's store spills one alignment string altered: the
    first hit's TFO of each record, its first letter changed."""
    from fasim_tpu_torch.post import store

    orig = store.TriplexStore.add_record

    def add(self, bucket, chro, hits):
        if hits:
            t = copy.copy(hits[0])
            s = t.stri_align
            t.stri_align = ("C" if s[:1] != "C" else "G") + s[1:]
            hits = [t, *hits[1:]]
        return orig(self, bucket, chro, hits)

    monkeypatch.setattr(store.TriplexStore, "add_record", add)


FAULTS = [_state_unchanged, _half_batch, _answer_altered, _output_altered]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_program_is_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    result, lines = run_tiny(tiny_cell)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("fault", [*FAULTS, _store_record_dropped,
                                   _spilled_string_altered])
def test_a_broken_streamed_program_is_not_correct(tiny_stream_cell,
                                                  monkeypatch, fault):
    fault(monkeypatch)
    result, lines = run_tiny(tiny_stream_cell)
    assert result["correct"] is False, lines
