"""Port model substrate vs the JAX package, on the CPU.

``convert.py`` round-trips the JAX parameter tree bit-exactly (dense and
factored leaves), and the converted llama3_1b SMOKE model's paged
``prefill_chunk`` and ``decode_step`` logits match the JAX model's at
rtol/atol 1e-4 (fp32), with block tables, ragged rows, a row resuming at a
nonzero start, and bucket-padding rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models.linear import linear_weight_matrix as j_weight_matrix
from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model
from repro_torch.models.linear import linear_weight_matrix

torch.set_num_threads(1)

CFG = get_smoke_config("llama3_1b")


@pytest.fixture(scope="module")
def jax_lm():
    jmodel = j_build(j_smoke("llama3_1b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _factored_tree(tree):
    """Replace wq and down of every rep by random b_t/a_t factors."""
    rng = np.random.RandomState(7)
    out = jax.tree.map(lambda a: a, tree)
    sub = out["blocks"]["sub0"]
    for parent, key in ((sub["mixer"], "wq"), (sub["ffn"], "down")):
        w = parent[key]["w"]
        n_rep, d_in, d_out = w.shape
        r = 5
        parent[key] = {"b_t": rng.standard_normal((n_rep, d_in, r)).astype(np.float32),
                       "a_t": rng.standard_normal((n_rep, r, d_out)).astype(np.float32)}
    return out


def _assert_tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("factored", [False, True])
def test_convert_round_trip_bit_exact(jax_lm, factored):
    _, _, tree = jax_lm
    if factored:
        tree = _factored_tree(tree)
    model = params_from_numpy(tree, CFG, device="cpu")
    _assert_tree_equal(params_to_numpy(model), tree)
    assert model.blocks[1]["sub0"].mixer.wq.is_factored == factored
    jwq = {k: v[1] for k, v in tree["blocks"]["sub0"]["mixer"]["wq"].items()}
    np.testing.assert_allclose(
        linear_weight_matrix(model.blocks[1]["sub0"].mixer.wq).numpy(),
        np.asarray(j_weight_matrix(jax.tree.map(jnp.asarray, jwq))),
        rtol=1e-5, atol=1e-6)
    names = set(model.state_dict())
    assert "blocks.1.sub0.mixer.wk.w" in names and "embed" in names


def test_convert_rejects_missing_leaf(jax_lm):
    _, _, tree = jax_lm
    bad = jax.tree.map(lambda a: a, tree)
    del bad["final_norm"]
    with pytest.raises(KeyError):
        params_from_numpy(bad, CFG, device="cpu")


def test_entry_points_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the refusal path is for CUDA-less torch")
    with pytest.raises(RuntimeError):
        build_model(CFG)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def _paged_cache_jax(num_blocks, bs):
    shape = (CFG.n_layers, num_blocks, bs, CFG.n_kv_heads, CFG.head_dim)
    return {"prefix": [], "blocks": {"sub0": {"mixer": {
        "k": jnp.zeros(shape, jnp.float32), "v": jnp.zeros(shape, jnp.float32)}}}}


def test_paged_prefill_and_decode_match_jax(jax_lm):
    jmodel, jparams, tree = jax_lm
    tmodel = params_from_numpy(tree, CFG, device="cpu")
    bs, num_blocks, l_pad = 4, 24, 16
    rng = np.random.RandomState(3)
    lens = [11, 5, 16]                        # ragged rows + one padding row
    tok = np.zeros((4, l_pad), np.int32)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.randint(0, CFG.vocab_size, n)
    starts = np.array([0, 0, 0, 0], np.int32)
    ln = np.array(lens + [1], np.int32)
    tables = np.zeros((4, 8), np.int32)      # row 3 all-trash
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-(n + 8) // bs)):   # room for decode and a resume
            tables[i, j] = nxt
            nxt += 1
    jcache = _paged_cache_jax(num_blocks, bs)
    tcache = tmodel.init_cache(num_blocks, bs)

    def both_prefill(tok, starts, ln):
        nonlocal jcache
        jl, jcache = jmodel.prefill_chunk(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(starts),
            jnp.asarray(ln), compute_dtype=jnp.float32,
            block_tables=jnp.asarray(tables))
        tl = tmodel.prefill_chunk(torch.from_numpy(tok), tcache,
                                  torch.from_numpy(starts), torch.from_numpy(ln),
                                  torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    def both_decode(tok, pos):
        nonlocal jcache
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
            compute_dtype=jnp.float32, block_tables=jnp.asarray(tables))
        tl = tmodel.decode_step(torch.from_numpy(tok), tcache,
                                torch.from_numpy(pos), torch.from_numpy(tables))
        return np.asarray(jl), tl.numpy()

    jl, tl = both_prefill(tok, starts, ln)
    np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-4, atol=1e-4)
    pos = np.array(lens + [0], np.int32)
    for _ in range(3):                        # a few paged decode steps
        nxt_tok = np.argmax(tl, -1).astype(np.int32)[:, None]
        nxt_tok[3] = 0
        jl, tl = both_decode(nxt_tok, pos)
        np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-4, atol=1e-4)
        pos[:3] += 1
    # row 1 resumes with a suffix at a nonzero start (cached-prefix offset)
    tok2 = np.zeros((4, 8), np.int32)
    tok2[1, :3] = rng.randint(0, CFG.vocab_size, 3)
    starts2 = np.array([0, pos[1], 0, 0], np.int32)
    ln2 = np.array([1, 3, 1, 1], np.int32)
    tok2[[0, 2, 3], 0] = 0
    jl, tl = both_prefill(tok2, starts2, ln2)
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-4, atol=1e-4)
    # the page stores the two models wrote agree on every page rows 0-2 own
    used = tables[:3][tables[:3] > 0]
    jk = np.asarray(jcache["blocks"]["sub0"]["mixer"]["k"])
    for layer in range(CFG.n_layers):
        np.testing.assert_allclose(tcache[layer]["k"].numpy()[used],
                                   jk[layer][used], rtol=1e-4, atol=1e-4)
