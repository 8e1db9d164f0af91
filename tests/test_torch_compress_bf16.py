"""Compression of a bf16 MoE model against the JAX package, on the CPU:
deepseek_moe_16b SMOKE built in bf16, calibrated and compressed with COALA
per expert through both packages. The per-expert solve meets a bf16 expert
with an fp32 R and fp32 factors; the reference's products promote it to
fp32, where the port once raised (``expected m1 and m2 to have the same
dtype``).

Weights are the reference's ``init(key, bfloat16)`` carried over through
fp32 numpy arrays (exact for bf16 values); tokens from numpy with a seed.
Tolerances: the reports' errors at 1e-4 (SVDs of the same matrices in two
libraries); every compressed projection's W' = A·B at 2⁻⁷ of its largest
entry, since each factor is rounded to bf16 (a relative 2⁻⁹) after SVDs
that differ in the last fp32 bits, so an entry may round the other way.
The calibration has 256 tokens: at 64, experts that saw fewer tokens than
the rank leave the directions outside their R's range to μ alone, where
the two libraries' factors part (their weighted errors, ~1e-7, agree).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import CompressConfig as JCompressConfig
from repro.configs import get_smoke_config as j_smoke
from repro.core.calibrate import calibrate_model as j_calibrate
from repro.core.compress import compress_model as j_compress
from repro.models import build_model as j_build
from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.calibrate import calibrate_model
from repro_torch.core.compress import compress_model

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    """path -> array; a factored expert bank's tuple as '<path>/0', '/1'."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                out[f"{prefix}{k}/{i}"] = np.asarray(x)
        elif isinstance(v, list):
            for i, x in enumerate(v):
                out.update(_leaves(x, f"{prefix}{k}/{i}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_bf16_moe_compression_matches_jax():
    """Reports equal in path and rank, errors at 1e-4; the factors stored
    in bf16 in both; every compressed projection's A·B at 2⁻⁷ of its
    largest entry."""
    name = "deepseek_moe_16b"
    jmodel = j_build(j_smoke(name))
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.bfloat16)
    assert jparams["blocks"]["sub0"]["ffn"]["w_gate"].dtype == jnp.bfloat16
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    tmodel = params_from_numpy(tree, get_smoke_config(name), device="cpu",
                               dtype=torch.bfloat16)
    assert tmodel.blocks[0]["sub0"].ffn.w_gate.w.dtype == torch.bfloat16
    tok = [np.random.RandomState(8).randint(0, 256, (8, 32)).astype(np.int32)]
    jcal = j_calibrate(jmodel, jparams, [{"tokens": jnp.asarray(b)} for b in tok])
    tcal = calibrate_model(tmodel, [torch.from_numpy(b) for b in tok])
    kw = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
    jc, jrep = j_compress(jmodel, jparams, jcal, JCompressConfig(**kw))
    tc, trep = compress_model(tmodel, tcal, CompressConfig(**kw))
    jd, td = {r.path: r for r in jrep}, {r.path: r for r in trep}
    assert sorted(td) == sorted(jd) and len(td) == 69
    for p, r in td.items():
        assert r.rank == jd[p].rank, p
        for f in ("rel_err_weighted", "rel_err_bound"):
            np.testing.assert_allclose(getattr(r, f), getattr(jd[p], f),
                                       rtol=0, atol=1e-4, equal_nan=True,
                                       err_msg=f"{p} {f}")
    bank = tc.blocks[0]["sub0"].ffn.w_down
    assert bank.is_factored and bank.b_t.dtype == torch.bfloat16
    want = _leaves(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jc))
    got = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                               params_to_numpy(tc.float())))
    n = 0
    for k in want:
        pair = ((k, k[:-3] + "a_t") if k.endswith("b_t") else
                (k, k[:-1] + "1") if k.endswith("/0") else None)
        if pair is None:
            continue
        w = np.einsum("...ir,...ro->...io", want[pair[0]], want[pair[1]])
        g = np.einsum("...ir,...ro->...io", got[pair[0]], got[pair[1]])
        np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=k)
        n += 1
    assert n > 0
