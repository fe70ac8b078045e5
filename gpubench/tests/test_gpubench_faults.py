"""The check fails a run whose timed path is broken underneath. The run
skips the look for a card and drives a tiny cell on the CPU, each time
with one fault planted in the program: a decode step that leaves the KV
cache as it was, each half of the decode batch answered with the other
half's logits, a served token altered where it is sampled. One chip: there is no
exchange between chips to leave out."""
import time

import pytest
import torch

from gpubench import run

CELL = "tiny-dense.tiny_chat"


def served(root):
    return run.run(CELL, 2 ** 36 + 11, 2.0, False, device="cpu", root=root,
                   t_start=time.perf_counter())


def test_sound_run_is_correct(tiny_root):
    out = served(tiny_root)
    assert out["correct"], out["checks"]
    assert out["checks"]["compared_tokens"]["value"] >= 20


def cache_left_unchanged(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "write_kv", lambda cache, new, idx: None)


def half_the_batch(monkeypatch):
    from repro_torch.serve import engine
    body = engine.decode_body

    def broken(*a, **k):
        out = body(*a, **k)
        h = out.shape[0] // 2
        return torch.cat([out[h:2 * h], out[:h], out[2 * h:]])
    monkeypatch.setattr(engine, "decode_body", broken)


def token_altered(monkeypatch):
    from repro_torch.serve.engine import Engine
    sample = Engine._sample

    def broken(self, logits):
        ids = sample(self, logits)
        ids[-1] = (ids[-1] + 1) % logits.shape[-1]
        return ids
    monkeypatch.setattr(Engine, "_sample", broken)


@pytest.mark.parametrize("fault", [cache_left_unchanged, half_the_batch, token_altered])
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = served(tiny_root)
    gap = out["checks"]["logit_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"], out["checks"]
