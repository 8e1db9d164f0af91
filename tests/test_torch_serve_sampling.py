"""Per-request sampling and stopping in the port's engine.

The port's samples cannot match ``jax.random``, so these are the sampling
invariants of ``tests/test_serve_continuous.py::test_per_request_temperature``
and more: a greedy row beside a sampled row keeps its greedy tokens; a seed
gives the same tokens on two runs and across a forced preemption (each
row's generator is seeded from (seed, output index)); different seeds
differ; and many draws from fixed logits follow softmax(logits / T) by a χ²
test at significance 0.001.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.linear import Linear
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.engine import row_seed, sample_rows

torch.set_num_threads(1)

CHI2_5DOF_P001 = 20.515     # χ² quantile at 1 - 0.001 with 5 degrees of freedom


@pytest.fixture(scope="module")
def model():
    """llama3_1b SMOKE with projections x3 and random norm scales, so its
    tokens vary from step to step."""
    m = build_model(get_smoke_config("llama3_1b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, Linear):
                mod.w.mul_(3.0)
        for name, p in m.named_parameters():
            if name.endswith("scale"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return m


def _engine(model, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_running", 4)
    return ContinuousEngine(model, **kw)


def _prompt(seed, n=6):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _serve(eng, reqs):
    """Submit (prompt, n, kwargs) requests one step apart, run to the end;
    tokens by request id."""
    for p, n, kw in reqs:
        eng.submit(p, n, **kw)
        eng.step()
    eng.run()
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


def test_greedy_row_beside_sampled_row(model):
    p = _prompt(2)
    alone = _serve(_engine(model), [(p, 8, {})])[0]
    mixed = _serve(_engine(model), [(p, 8, dict(temperature=0.0)),
                                    (p, 8, dict(temperature=1.5, seed=7))])
    assert mixed[0] == alone
    assert len(mixed[1]) == 8 and mixed[1] != alone


def test_seed_repeats_across_runs_and_preemption(model):
    """The same seeds give the same tokens on a second run and on a pool
    small enough to preempt (the victim re-prefills and draws the same key
    for the same output index)."""
    reqs = [(_prompt(i, 5 + i), 10, dict(temperature=1.0, seed=11 + i))
            for i in range(3)]
    big = _serve(_engine(model), reqs)
    again = _serve(_engine(model), reqs)
    small_eng = _engine(model, block_size=2, num_blocks=13, max_running=3)
    small = _serve(small_eng, reqs)
    assert small_eng.metrics()["preemptions"] > 0
    assert big == again == small


def test_different_seeds_differ(model):
    p = _prompt(3)
    runs = _serve(_engine(model), [(p, 10, dict(temperature=1.0, seed=s))
                                   for s in (1, 2, 3)])
    assert runs[0] != runs[1] and runs[1] != runs[2] and runs[0] != runs[2]


def test_fork_default_seed_diverges(model):
    """A fork at temperature > 0 without a seed draws its own stream."""
    eng = _engine(model)
    rid = eng.submit(_prompt(4), 10, temperature=1.0, seed=5)
    eng.step()
    cid = eng.fork(rid)
    eng.run()
    fin = {r.req_id: r.out_tokens for r in eng.finished}
    assert fin[rid][:2] == fin[cid][:2] and fin[rid] != fin[cid]


def test_eos_stops_sampled_request(model):
    p = _prompt(6)
    toks = _serve(_engine(model), [(p, 12, dict(temperature=1.0, seed=9))])[0]
    eos = toks[4]
    cut = toks.index(eos) + 1
    stopped = _serve(_engine(model),
                     [(p, 12, dict(temperature=1.0, seed=9, eos_id=eos))])[0]
    assert stopped == toks[:cut]


@pytest.mark.parametrize("temp", [0.7, 1.0, 2.5])
def test_sample_frequencies_follow_softmax(temp):
    """20000 draws (seeds 0..19999, output index 0) from fixed logits:
    χ² against softmax(logits / T) below its 0.001 quantile, 5 dof."""
    logits = torch.tensor([1.0, 0.2, -0.5, 2.0, 0.0, 1.3])
    n = 20000
    rows = logits.expand(n, -1).contiguous()
    draws = sample_rows(rows, [temp] * n, list(range(n)), [0] * n)
    counts = np.bincount(draws.numpy(), minlength=6)
    expect = n * torch.softmax(logits / temp, -1).double().numpy()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_5DOF_P001, (chi2, counts, expect)


def test_sample_rows_greedy_and_keys():
    """Rows at temperature <= 0 take the argmax; a sampled row's draw is a
    function of (seed, index) only, and the key changes with either."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 50), generator=gen)
    out = sample_rows(logits, [0.0, 1.0, -1.0, 1.0], [3, 3, 3, 3], [0, 2, 0, 2])
    assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
    again = sample_rows(logits[1:2], [1.0], [3], [2])
    assert again[0] == out[1]
    assert len({row_seed(3, 2), row_seed(3, 3), row_seed(4, 2)}) == 3
