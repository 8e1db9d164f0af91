"""The port's self-speculative decoding against the JAX ``ContinuousEngine``.

Target and draft weights come from one JAX tree carried across as numpy
(``convert.params_from_numpy``): llama3_1b SMOKE with its projections x3
and random norm scales (so greedy tokens vary from step to step), and two
drafts: the same tree perturbed as ``tests/test_spec_decode.py`` perturbs it
(0.02 N(0, 1) on every matrix: every proposal is rejected) and perturbed 20x
less (some proposals are accepted).
Both engines serve the staggered and the preempting traces of
``tests/test_spec_decode.py`` in fp32: the port's speculative greedy tokens
must equal the JAX speculative engine's and the port's own non-speculative
engine's, and the accepted-token counts must equal JAX's. Rejection
sampling draws with numpy generators seeded exactly as the JAX engine
seeds them, so it is bit-identical on the same arrays; the draft's own
samples cannot match ``jax.random``, so sampled runs are held to invariants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model_pair as j_compress_pair
from repro.core.compress import rank_map_from_reports as j_rank_map
from repro.models import build_model as j_build
from repro.serve import ContinuousEngine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model_pair, rank_map_from_reports
from repro_torch.serve import ContinuousEngine
from repro_torch.serve.scheduler import Request

torch.set_num_threads(1)

# the traces of tests/test_spec_decode.py: staggered joins (spec_k 3) and a
# pool of 16 two-token pages that preempts mid-round (spec_k 2)
TRACES = {
    "staggered": (dict(block_size=4, num_blocks=64, max_running=3), 3),
    "preempting": (dict(block_size=2, num_blocks=16, max_running=3), 2),
}
SPEC_COUNTERS = ("spec_rounds", "spec_proposed_tokens", "spec_accepted_tokens")


def _varied(tree, seed=0):
    """Projections x3 and norm scales ~ N(0, 0.25)."""
    rng = np.random.RandomState(seed)

    def tweak(path, x):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            return x
        if "scale" in name:
            return (rng.standard_normal(x.shape) * 0.5).astype(np.float32)
        return x * np.float32(3.0)
    return jax.tree_util.tree_map_with_path(tweak, tree)


def _perturbed(params, scale=0.02):
    """tests/test_spec_decode.py's draft: every matrix + scale N(0, 1)."""
    def perturb(path, leaf):
        if getattr(leaf, "ndim", 0) < 2:
            return leaf
        key = jax.random.PRNGKey(len(jax.tree_util.keystr(path)))
        return leaf + scale * jax.random.normal(key, leaf.shape, leaf.dtype)
    return jax.tree_util.tree_map_with_path(perturb, params)


DRAFT_SCALES = {"perturbed": 0.02, "close": 0.001}


@pytest.fixture(scope="module")
def models():
    """JAX model, JAX target params, port target, and per draft name the
    (JAX draft params, port draft)."""
    cfg = get_smoke_config("llama3_1b")
    jmodel = j_build(j_smoke("llama3_1b"))
    tree = _varied(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, tree)
    port = params_from_numpy(tree, cfg, device="cpu")
    drafts = {}
    for name, scale in DRAFT_SCALES.items():
        jdraft = _perturbed(jparams, scale)
        drafts[name] = jdraft, params_from_numpy(
            jax.tree.map(np.asarray, jdraft), cfg, device="cpu")
    return jmodel, jparams, port, drafts


def _trace(name, vocab):
    if name == "staggered":
        rng = np.random.RandomState(0)
        return [(rng.randint(0, vocab, (n,)).astype(np.int32), m)
                for n, m in zip([3, 9, 5, 12], [5, 3, 7, 2])]
    rng = np.random.RandomState(7)
    return [(rng.randint(0, vocab, (4,)).astype(np.int32), 6) for _ in range(3)]


def _drive(eng, name, trace):
    if name == "staggered":
        for p, n in trace:
            eng.submit(p, n)
            eng.step()                      # joiners land mid-round
    else:
        for p, n in trace:
            eng.submit(p, n)
    eng.run()
    return {r.req_id: list(r.out_tokens) for r in eng.finished}


@pytest.fixture(scope="module")
def jax_spec_runs(models):
    """The JAX speculative engine per (trace, draft): (tokens, metrics)."""
    jmodel, jparams, _, drafts = models
    vocab = get_smoke_config("llama3_1b").vocab_size
    out = {}
    for name, (knobs, k) in TRACES.items():
        for dname, (jdraft, _) in drafts.items():
            eng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                          cache_dtype=jnp.float32, draft_params=jdraft,
                          spec_k=k, async_detok=False, **knobs)
            out[name, dname] = (_drive(eng, name, _trace(name, vocab)),
                                eng.metrics())
    return out


@pytest.mark.parametrize("dname", list(DRAFT_SCALES))
@pytest.mark.parametrize("name", list(TRACES))
def test_spec_greedy_matches_jax_and_nonspec(models, jax_spec_runs, name, dname):
    """Greedy speculative tokens equal the JAX speculative engine's and the
    port's non-speculative engine's, request by request; proposals,
    acceptances and rounds equal JAX's. The perturbed draft has every
    proposal rejected (the preempting trace preempts mid-round with it);
    the close one has some accepted."""
    _, _, port, drafts = models
    knobs, k = TRACES[name]
    trace = _trace(name, get_smoke_config("llama3_1b").vocab_size)
    spec = ContinuousEngine(port, draft_model=drafts[dname][1], spec_k=k,
                            **knobs)
    toks = _drive(spec, name, trace)
    plain = _drive(ContinuousEngine(port, **knobs), name, trace)
    jtoks, jm = jax_spec_runs[name, dname]
    m = spec.metrics()
    assert toks == jtoks == plain
    assert [len(toks[i]) for i in sorted(toks)] == [n for _, n in trace]
    assert {c: m[c] for c in SPEC_COUNTERS} == {c: jm[c] for c in SPEC_COUNTERS}
    assert m["spec_rounds"] > 0 and m["spec_accept_rate"] < 1.0
    assert m["preemptions"] == jm["preemptions"]
    if dname == "close":
        assert m["spec_accepted_tokens"] > 0
    elif name == "preempting":
        assert m["preemptions"] > 0
    # both pools drained in lockstep
    for pool in (spec.pool, spec.draft_pool):
        assert pool.available_blocks == pool.usable_blocks


def test_identical_draft_accepts_everything(models):
    """draft == target: every proposal matches the verifier's argmax, so the
    accept rate is exactly 1.0 and max_new_tokens still truncates."""
    _, _, port, _ = models
    vocab = get_smoke_config("llama3_1b").vocab_size
    rng = np.random.RandomState(5)
    prompts = [(rng.randint(0, vocab, (n,)).astype(np.int32), m)
               for n, m in ((5, 9), (8, 6))]
    knobs = TRACES["staggered"][0]
    runs = []
    for kw in (dict(draft_model=port, spec_k=3), {}):
        eng = ContinuousEngine(port, **knobs, **kw)
        for p, n in prompts:
            eng.submit(p, n)
        eng.run()
        runs.append((eng, {r.req_id: r.out_tokens for r in eng.finished}))
    (spec, toks), (_, plain) = runs
    assert spec.metrics()["spec_accept_rate"] == 1.0
    assert toks == plain and sorted(map(len, toks.values())) == [6, 9]


@pytest.mark.parametrize("case", ["random", "equal", "hot"])
def test_spec_accept_sampled_bit_identical_to_jax(models, case):
    """Rejection sampling on the same (d, target logits, draft logits):
    the same tokens and acceptance count as the JAX engine's, bit for bit
    (rejections with residual draws, a full accept with a bonus draw)."""
    jmodel, jparams, port, drafts = models
    jdraft, draft = drafts["perturbed"]
    k = 4
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, draft_params=jdraft, spec_k=k,
                   async_detok=False, block_size=4, num_blocks=16)
    eng = ContinuousEngine(port, draft_model=draft, spec_k=k, block_size=4,
                           num_blocks=16)
    rng = np.random.RandomState({"random": 0, "equal": 1, "hot": 2}[case])
    vocab = 64
    for trial in range(6):
        vlog = rng.standard_normal((k + 1, vocab)).astype(np.float32)
        dlog = vlog.copy() if case == "equal" else (
            vlog + rng.standard_normal((k + 1, vocab)).astype(np.float32) * 0.5)
        if case == "hot":
            vlog *= 4.0
        d = [int(t) for t in rng.randint(0, vocab, k)]
        if case != "random":
            d = [int(np.argmax(row)) for row in dlog[:k]]
        out = list(rng.randint(0, vocab, trial + 1))
        kw = dict(req_id=0, prompt=np.zeros(3, np.int32), max_new_tokens=99,
                  temperature=[0.7, 1.0, 1.5][trial % 3], seed=11 + trial)
        jr, r = JRequest(**kw), Request(**kw)
        jr.out_tokens, r.out_tokens = list(out), list(out)
        want = jeng._spec_accept_sampled(jr, d, vlog, dlog)
        got = eng._spec_accept_sampled(r, d, vlog, dlog)
        assert got == want
        if case == "equal":
            assert got[1] == k and len(got[0]) == k + 1


def test_sampled_spec_repeats_and_stops_at_eos(models):
    """A sampled speculative run repeats under the same seeds on a fresh
    engine; with an ``eos_id`` taken from that run a request stops right
    after emitting it, on the same trajectory up to there."""
    _, _, port, drafts = models
    draft = drafts["close"][1]
    vocab = get_smoke_config("llama3_1b").vocab_size
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (5, 7)]
    knobs = TRACES["staggered"][0]

    def run(eos=None):
        eng = ContinuousEngine(port, draft_model=draft, spec_k=3, **knobs)
        for i, p in enumerate(prompts):
            eng.submit(p, 10, temperature=1.2, seed=13 + i,
                       eos_id=None if eos is None else eos[i])
        eng.run()
        return eng, {r.req_id: r.out_tokens for r in eng.finished}

    eng, first = run()
    _, second = run()
    assert first == second
    assert eng.metrics()["spec_rounds"] > 0
    assert all(len(t) == 10 for t in first.values())
    eos = [first[0][3], first[1][6]]
    _, stopped = run(eos)
    for i in (0, 1):
        stop = first[i].index(eos[i]) + 1
        assert stopped[i] == first[i][:stop]


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_spec_warmup_signatures_match_jax(models, prefix_cache):
    """In speculative mode the decode set is the spec rounds' over
    max_len + spec_k; the prefill set is unchanged."""
    jmodel, jparams, port, drafts = models
    jdraft, draft = drafts["perturbed"]
    knobs = dict(block_size=4, num_blocks=24, max_running=3,
                 prefix_cache=prefix_cache)
    jeng = JEngine(jmodel, jparams, compute_dtype=jnp.float32,
                   cache_dtype=jnp.float32, draft_params=jdraft, spec_k=3,
                   async_detok=False, **knobs)
    eng = ContinuousEngine(port, draft_model=draft, spec_k=3, **knobs)
    for max_len in (13, 16, 40):
        jdec, jpre = jeng.warmup_signatures(max_len)
        dec, pre = eng.warmup_signatures(max_len)
        assert dec == [(b, nb) for b, nb, _ in jdec]
        assert pre == list(jpre)


def test_compress_model_pair_matches_jax():
    """Target and draft from one calibration pass: the same layers and
    ranks as JAX's (the draft at its own ratio, no rank override), W' = A·B
    at rtol 1e-4 / atol 1e-5, and equal rank maps."""
    jmodel = j_build(j_smoke("llama3_1b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    toks = [rng.randint(0, 256, (4, 32)).astype(np.int32) for _ in range(2)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(t)} for t in toks])
    port = params_from_numpy(jax.tree.map(np.asarray, jparams),
                             get_smoke_config("llama3_1b"), device="cpu")
    cal = calibrate_model(port, [torch.from_numpy(t) for t in toks])
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0, rank=5)
    jt, jd, jtrep, jdrep = j_compress_pair(jmodel, jparams, jcal,
                                           JCompressConfig(**kw), draft_ratio=0.3)
    t, d, trep, drep = compress_model_pair(port, cal, CompressConfig(**kw),
                                           draft_ratio=0.3)
    assert {r.rank for r in trep} == {5}            # the override: target only
    for reps, jreps in ((trep, jtrep), (drep, jdrep)):
        assert rank_map_from_reports(reps) == j_rank_map(jreps)
        assert len(reps) == 14
    assert {r.rank for r in drep} != {5}
    for tree, jtree in ((params_to_numpy(t), jt), (params_to_numpy(d), jd)):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        for path, jb in jax.tree_util.tree_leaves_with_path(jtree):
            if jax.tree_util.keystr(path).endswith("['b_t']"):
                apath = path[:-1] + (jax.tree_util.DictKey("a_t"),)
                ja = dict(jax.tree_util.tree_leaves_with_path(jtree))[apath]
                want = np.einsum("...ir,...ro->...io", np.asarray(jb), np.asarray(ja))
                got = np.einsum("...ir,...ro->...io", flat[path], flat[apath])
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="draft_ratio"):
        compress_model_pair(port, cal, CompressConfig(**kw), draft_ratio=1.0)


def test_spec_k_must_be_positive(models):
    _, _, port, drafts = models
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousEngine(port, draft_model=drafts["perturbed"][1], spec_k=0)
