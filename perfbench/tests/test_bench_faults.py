"""The check fails what it must: each fault a cell can have, planted
under a whole run at a tiny size on the CPU (the look for a card
skipped), and the lower-precision control, all come out not correct;
the sound program comes out correct."""

import dataclasses
import json

import pytest

from perfbench import run
from tiny import tiny_root

SEED = 2**31 + 77


def outcome(root, cell, capsys, options=None):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.5", "--trace", "0"], device="cpu", root=root,
                  options=options)
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny_dense.tiny_train",
                                  "tiny_moe.tiny_train",
                                  "tiny_dense.tiny_serve",
                                  "tiny_moe.tiny_serve"])
def test_sound_runs_are_correct(root, cell, capsys):
    assert outcome(root, cell, capsys)["correct"] is True


def test_a_step_that_leaves_its_state_unchanged(root, capsys, monkeypatch):
    from repro_torch.train import train_loop

    monkeypatch.setattr(train_loop, "adamw_update",
                        lambda params, grads, state, cfg: (params, state))
    out = outcome(root, "tiny_dense.tiny_train", capsys)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root, capsys, monkeypatch):
    from repro_torch.train import train_loop

    whole = train_loop.loss_and_grads

    def half(cfg, params, batch, mark=None):
        rows = next(iter(batch.values())).shape[0] // 2
        return whole(dataclasses.replace(cfg, microbatch=1), params,
                     {k: v[:rows] for k, v in batch.items()}, mark)

    monkeypatch.setattr(train_loop, "loss_and_grads", half)
    assert outcome(root, "tiny_dense.tiny_train", capsys)["correct"] is False


def altered_tokens(engine):
    """Every decoded token moved to the next id where it is produced."""
    decode = engine._decode

    def wrong(params, tokens, caches):
        logits, caches = decode(params, tokens, caches)
        return logits.roll(1, dims=-1), caches

    engine._decode = wrong


@pytest.mark.parametrize("cell", ["tiny_dense.tiny_serve",
                                  "tiny_moe.tiny_serve"])
def test_a_token_altered_where_it_is_produced(root, cell, capsys):
    out = outcome(root, cell, capsys, {"engine_hook": altered_tokens})
    assert out["correct"] is False


def test_a_decode_that_leaves_the_cache_unwritten(root, capsys,
                                                  monkeypatch):
    from repro_torch.models import common

    write = common._write_cache

    def stale(cache, k, v):
        if k.shape[1] > 1:            # prefill writes, decode does not
            write(cache, k, v)

    monkeypatch.setattr(common, "_write_cache", stale)
    out = outcome(root, "tiny_dense.tiny_serve", capsys)
    assert out["correct"] is False
