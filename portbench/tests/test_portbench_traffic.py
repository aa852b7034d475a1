"""The traffic: the same seed gives the same inputs, and every wave does the
same work."""
import json

import torch

from portbench.bench import Bench

from .conftest import ROOT

B = Bench(ROOT)
SERVE = B.mix(B.cell("deepseek-7b.serve_longdoc"))
TRAIN = B.mix(B.cell("deepseek-7b.train_8k"))
SEED = 3_000_000_017  # more than 32 bits hold
kind = B.kind(SERVE)


def test_a_wave_holds_the_quantile_midpoints():
    prompts = kind.lengths(SERVE["prompt"], 32)
    outputs = kind.lengths(SERVE["output"], 32)
    assert prompts[0] == 562 and prompts[15] == 2000 and prompts[-4:] == [4032] * 4
    assert outputs[0] == 4 and outputs[-1] == 64
    assert max(prompts) + max(outputs) <= SERVE["max_len"]
    assert sum(prompts) == 71765 and sum(outputs) == 639


def test_every_wave_does_the_same_work_and_the_seed_moves_the_ids():
    want_p = sorted(kind.lengths(SERVE["prompt"], 32))
    want_o = sorted(kind.lengths(SERVE["output"], 32))
    waves = [kind.wave(SERVE, 102400, seed, i) for seed in (SEED, SEED + 1) for i in (1, 2)]
    for w in waves:
        assert sorted(len(p) for p, _ in w) == want_p and sorted(n for _, n in w) == want_o
        assert [(len(p), n) for p, n in w] == kind.sizes(SERVE)  # one order for every wave and seed
        assert all(0 <= t < 102400 for p, _ in w for t in p)
    assert kind.sizes(SERVE) != sorted(kind.sizes(SERVE))  # shuffled, and paired by the shuffle
    ids = {tuple(w[0][0][:16]) for w in waves}
    assert len(ids) == 4


def test_the_same_seed_gives_the_same_inputs():
    assert kind.wave(SERVE, 102400, SEED, 3) == kind.wave(SERVE, 102400, SEED, 3)
    assert kind.warmup(SERVE, 102400, SEED) == kind.warmup(SERVE, 102400, SEED)
    train = B.kind(TRAIN)
    cfg = {"vocab_size": 1000}
    mix = dict(TRAIN, batch=2, seq=16)
    a, b = train.feed(cfg, mix, SEED, "cpu"), train.feed(cfg, mix, SEED, "cpu")
    first = [next(a) for _ in range(3)]
    for x in first:
        y = next(b)
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
        assert x["tokens"].dtype == torch.int32 and x["tokens"].shape == (2, 16)
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    assert not torch.equal(first[0]["tokens"], next(train.feed(cfg, mix, SEED + 1, "cpu"))["tokens"])


def test_the_check_sample_holds_the_longest_requests():
    done = [([0] * p, [1] * g, g) for p, g in [(10, 3), (50, 2), (20, 9), (30, 4), (40, 1)]]
    picked = kind.sample(done, SEED, 12)
    assert picked[:2] == [1, 2] and sum(len(done[i][1]) for i in picked) >= 12
    assert picked == kind.sample(done, SEED, 12)


def test_mixes_state_what_the_generator_reads():
    for name in ("serve_longdoc", "train_8k"):
        mix = json.loads((ROOT / "portbench" / "workloads" / f"{name}.json").read_text())
        assert (ROOT / "portbench" / "traffic" / f"{mix['kind']}.py").is_file()
