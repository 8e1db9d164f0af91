"""Sharded Gram-free calibration of the port (``repro_torch.dist``) on gloo
ranks of the CPU, against the JAX package's ``repro.dist.calibrate`` on
fake devices.

One JAX subprocess on 4 fake host devices (as tests/test_dist_calibrate.py
runs the reference on 8) serves the module through a module-scoped
fixture; while it runs, the fixture runs one 4-rank gloo spawn and the
compress launcher with and without ``--mesh data=4`` (whose ranks the
launcher spawns). Both packages read the same parameters (the port's SMOKE
init from a seed, written in the reference's flat checkpoint layout by
``convert.state_to_flat``, so the two runs need not wait for each other)
and the same seeded numpy batches.

Tolerances: paths and token counts equal; R after ``_fix_sign`` within
2e-4·max|R| (the reference test's 2e-4) where cond(R) < 1e5 — the
reference's own test compares R entrywise only there, since R is unique up
to a left-orthogonal factor whose entrywise footprint grows with cond —
and RᵀR everywhere within 1e-5 relative (in Frobenius norm); COALA's
W' = A·B at 1e-4·max|W'| and its reports at rtol 1e-4 (as
tests/test_torch_compress.py). The butterfly against the serial QR at
2e-4 (the reference's tests/test_dist.py). The ill-conditioned case
mirrors tests/test_dist_calibrate.py at cond 1e9 over 4 shards.
"""
import contextlib
import io
import math
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.config import CompressConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import load_flat, state_to_flat
from repro_torch.core import baselines
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.coala import coala_project
from repro_torch.core.compress import compress_model
from repro_torch.core.tsqr import _fix_sign, distributed_tsqr_r, qr_r, square_r
from repro_torch.dist import group
from repro_torch.dist.calibrate import (ShardedCalibration, calibrate_sharded,
                                        combine_r_shards, split_batch)
from repro_torch.launch import compress as launch_compress
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
SHARDS = (1, 2, 4)
JOIN_S = 400.0                 # deadline of the spawn and of the JAX run (loaded runner)
COALA = dict(method="coala", ratio=0.6, lam=4.0, mu=-1.0)
ILL = dict(n=32, k=512, rank=6, cond=1e9)

# the reference: calibrate_sharded on 1-, 2- and 4-device meshes for
# smollm_135m SMOKE, on 4 for deepseek_moe_16b SMOKE, and COALA from the
# 4-device R factors
JAX_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import CompressConfig
    from repro.configs import get_smoke_config
    from repro.core.compress import compress_model
    from repro.dist.calibrate import calibrate_sharded
    from repro.models import build_model

    d = sys.argv[1]
    def key(path):
        return "/".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)

    def load(arch):
        model = build_model(get_smoke_config(arch))
        flat = np.load(f"{d}/{arch}_params.npz")
        tmpl = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        leaves, tdef = jax.tree_util.tree_flatten_with_path({"params": tmpl})
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(flat[key(p)]) for p, _ in leaves])["params"]
        return model, params

    def batches(name):
        return [{"tokens": jnp.asarray(t)} for t in np.load(f"{d}/{name}.npy")]

    def mesh(n):
        return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,))

    def save(name, cal):
        out = {}
        for p, r in cal.r_factors().items():
            out["r:" + p] = np.asarray(r)
            out["t:" + p] = np.asarray(cal.tokens_seen()[p])
        np.savez(f"{d}/jax_{name}.npz", **out)

    model, params = load("smollm_135m")
    for n in (1, 2, 4):
        cal = calibrate_sharded(model, params, batches(f"smollm_135m_{n}"), mesh(n))
        save(f"smollm_{n}", cal)
    cparams, reports = compress_model(model, params, cal, CompressConfig(
        method="coala", ratio=0.6, lam=4.0, mu=-1.0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(cparams)
    np.savez(f"{d}/jax_coala.npz",
             **{key(p): np.asarray(v) for p, v in leaves},
             **{f"report:{r.path}": np.asarray(
                 [r.rank, r.mu, r.rel_err_weighted, r.rel_err_bound,
                  r.params_before, r.params_after], np.float64) for r in reports})
    model, params = load("deepseek_moe_16b")
    save("deepseek_4", calibrate_sharded(model, params, batches("deepseek_moe_16b_4"),
                                         mesh(4)))
    print("OK")
""")


def _inputs(d: Path) -> None:
    """The port's SMOKE params and seeded token batches, written for both
    packages: for smollm at n shards one (4n, 64) batch, so that every
    shard's forward has the same shapes at every n (the reference's eager
    ops compile once); for deepseek at 4 one (4, 8) batch, so that 1-row
    shards leave some experts unrouted on some ranks."""
    for arch, seed, shards, rows, seq in (("smollm_135m", 0, SHARDS, 4, 64),
                                          ("deepseek_moe_16b", 1, (4,), 1, 8)):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
        flat = state_to_flat({"params": model})
        np.savez(d / f"{arch}_params.npz", **flat)
        rng = np.random.RandomState(seed)
        for n in shards:
            toks = rng.randint(0, cfg.vocab_size, (1, rows * n, seq))
            np.save(d / f"{arch}_{n}.npy", toks.astype(np.int32))


def _port_model(d: Path, arch: str):
    """The model ``_inputs`` wrote, loaded back from the file the reference
    reads."""
    model = build_model(get_smoke_config(arch), device="cpu")
    with np.load(d / f"{arch}_params.npz") as flat:
        load_flat({"params": model}, {k: flat[k] for k in flat.files})
    return model


def _batches(d: Path, name: str):
    return [torch.from_numpy(t) for t in np.load(d / f"{name}.npy")]


def _np(factors):
    return {p: r.numpy() for p, r in factors.items()}


def _ill_conditioned():
    """X (n, k) with singular values logspaced over ``cond``, and W."""
    n, k, cond = ILL["n"], ILL["k"], ILL["cond"]
    rng = np.random.RandomState(30)
    u = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v = np.linalg.qr(rng.standard_normal((k, n)))[0]
    s = np.logspace(0, -np.log10(cond), n)
    x = ((u * s[None, :]) @ v.T).astype(np.float32)
    w = rng.standard_normal((24, n)).astype(np.float32)
    return x, w


def port_ranks(d: str) -> dict:
    """Every rank's part: the port's calibrate_sharded on 1-, 2- and 4-shard
    ``data`` axes of one 4-rank world (meshes (4, 1), (2, 2) and (4,)), on
    deepseek at 4, COALA from the 4-shard factors on rank 0, the butterfly
    against serial QR, a group of 3 refused, and the ill-conditioned case's
    sharded R and distributed Gram sum."""
    d = Path(d)
    me = dist.get_rank()
    out = {"rank": me}
    model = _port_model(d, "smollm_135m")
    meshes = {1: make_mesh((RANKS, 1), ("rep", "data"), device="cpu"),
              2: make_mesh((RANKS // 2, 2), ("rep", "data"), device="cpu"),
              4: make_mesh((RANKS,), ("data",), device="cpu")}
    for n, mesh in meshes.items():
        cal = calibrate_sharded(model, _batches(d, f"smollm_135m_{n}"), mesh, axis="data")
        assert isinstance(cal, ShardedCalibration) and cal.n_shards == n
        out[f"smollm_{n}"] = (_np(cal.r_factors()), cal.tokens_seen())
    if me == 0:
        cmodel, reports = compress_model(model, cal, CompressConfig(**COALA))
        out["coala"] = (state_to_flat({"params": cmodel}), reports)

    model = _port_model(d, "deepseek_moe_16b")
    batches = _batches(d, "deepseek_moe_16b_4")
    cal = calibrate_sharded(model, batches, meshes[4], axis="data")
    local = Calibrator()
    for b in batches:
        model.capture_forward(split_batch(b, RANKS)[me], local)
    out["deepseek_4"] = (_np(cal.r_factors()), cal.tokens_seen())
    out["deepseek_local_paths"] = sorted(local.streams)

    rows = torch.from_numpy(np.random.RandomState(10).standard_normal(
        (RANKS * 40, 24)).astype(np.float32))
    out["butterfly"] = distributed_tsqr_r(rows[me * 40:(me + 1) * 40]).numpy()
    three = dist.new_group([0, 1, 2])
    if me < 3:
        try:
            distributed_tsqr_r(rows[:40], three)
        except ValueError as e:
            out["three"] = str(e)

    x, _ = _ill_conditioned()
    k = ILL["k"] // RANKS
    xt = torch.from_numpy(np.ascontiguousarray(x.T[me * k:(me + 1) * k]))
    out["ill_r"] = combine_r_shards(square_r(qr_r(xt)), meshes[4]).numpy()
    gram = xt.T @ xt
    dist.all_reduce(gram)
    out["ill_gram"] = gram.numpy()
    return out


LAUNCH = ["--smoke", "--device", "cpu", "--pretrain-steps", "4", "--calib-batches", "2"]


def _launch(argv):
    """The compress launcher's result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_compress.main(argv)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def runs():
    """(the port's per-rank results, the reference's npz files by name, the
    launcher's single-device and ``--mesh data=4`` runs)."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        _inputs(d)
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
        jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, tmp], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
        try:
            port = group.run(RANKS, port_ranks, (tmp,), device="cpu", timeout=JOIN_S)
            launched = (_launch(LAUNCH), _launch(
                LAUNCH + ["--mesh", "data=4", "--numerics-report"]))
            out, err = jax_run.communicate(timeout=JOIN_S)
        finally:
            if jax_run.poll() is None:
                jax_run.kill()
                jax_run.communicate()
        assert jax_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
        ref = {}
        for f in d.glob("jax_*.npz"):
            with np.load(f) as z:
                ref[f.stem[4:]] = {k: z[k] for k in z.files}
        yield port, ref, launched


def _ref_cal(ref: dict):
    return ({k[2:]: v for k, v in ref.items() if k.startswith("r:")},
            {k[2:]: int(v) for k, v in ref.items() if k.startswith("t:")})


def _check_r(got: dict, want: dict, tokens: dict) -> int:
    """R entrywise where well-conditioned and full rank, RᵀR everywhere;
    returns how many paths were compared entrywise."""
    entrywise = 0
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape, p
        gram_w = w.T.astype(np.float64) @ w
        gram_g = g.T.astype(np.float64) @ g
        rel = np.linalg.norm(gram_g - gram_w) / np.linalg.norm(gram_w)
        assert rel <= 1e-5, (p, rel)
        sv = np.linalg.svd(w.astype(np.float64), compute_uv=False)
        if tokens[p] >= w.shape[0] and sv[-1] > 0 and sv[0] / sv[-1] < 1e5:
            entrywise += 1
            np.testing.assert_allclose(
                _fix_sign(torch.from_numpy(g)).numpy(),
                _fix_sign(torch.from_numpy(w)).numpy(),
                rtol=0, atol=2e-4 * np.abs(w).max(), err_msg=p)
    return entrywise


@pytest.mark.parametrize("shards", SHARDS)
def test_paths_and_tokens_match_reference(runs, shards):
    port, ref, _ = runs
    want_r, want_t = _ref_cal(ref[f"smollm_{shards}"])
    got_r, got_t = port[0][f"smollm_{shards}"]
    assert list(got_r) == list(want_r) and len(got_r) == 14
    assert got_t == want_t
    assert set(got_t.values()) == {4 * shards * 64}


@pytest.mark.parametrize("shards", SHARDS)
def test_r_factors_match_reference(runs, shards):
    port, ref, _ = runs
    want_r, want_t = _ref_cal(ref[f"smollm_{shards}"])
    got_r, _ = port[0][f"smollm_{shards}"]
    assert _check_r(got_r, want_r, want_t) >= 10    # all but the two wo


@pytest.mark.parametrize("shards", SHARDS)
def test_every_rank_holds_the_same_r(runs, shards):
    port, _, _ = runs
    r0, t0 = port[0][f"smollm_{shards}"]
    for other in port[1:]:
        r, t = other[f"smollm_{shards}"]
        assert t == t0
        for p in r0:
            np.testing.assert_array_equal(r[p], r0[p], err_msg=p)


def test_moe_partial_coverage_matches_reference(runs):
    """deepseek_moe_16b SMOKE on 4 ranks of one row each: experts that some
    ranks never routed to go through the serial tree; paths (in the
    reference's order), token counts and RᵀR equal the reference's."""
    port, ref, _ = runs
    want_r, want_t = _ref_cal(ref["deepseek_4"])
    got_r, got_t = port[0]["deepseek_4"]
    assert list(got_r) == list(want_r) and got_t == want_t
    _check_r(got_r, want_r, want_t)
    local = [set(p["deepseek_local_paths"]) for p in port]
    partial = set.union(*local) - set.intersection(*local)
    assert partial and all(p in got_r for p in partial)
    for other in port[1:]:
        for p, r in other["deepseek_4"][0].items():
            np.testing.assert_array_equal(r, got_r[p], err_msg=p)


def test_coala_from_sharded_r_matches_reference(runs):
    """The slice as a whole: COALA 0.6 from the 4-rank R factors against the
    reference's compression from its 4-device R."""
    port, ref, _ = runs
    flat, reports = port[0]["coala"]
    want = ref["coala"]
    factored = [k[:-4] for k in want if k.endswith("/b_t")]
    assert len(factored) == 7           # per projection, stacked over reps
    for k in factored:
        w = np.matmul(want[k + "/b_t"], want[k + "/a_t"])
        g = np.matmul(flat["params/" + k + "/b_t"], flat["params/" + k + "/a_t"])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    jrep = {k[7:]: v for k, v in want.items() if k.startswith("report:")}
    assert sorted(jrep) == sorted(r.path for r in reports) and len(reports) == 14
    for r in reports:
        rank, mu, err, bound, before, after = jrep[r.path]
        assert (r.rank, r.params_before, r.params_after) == (rank, before, after)
        np.testing.assert_allclose(r.rel_err_weighted, err, rtol=1e-4)
        np.testing.assert_allclose(r.rel_err_bound, bound, rtol=1e-4)
        np.testing.assert_allclose(r.mu, mu, rtol=1e-3)


def test_distributed_tsqr_matches_serial_qr(runs):
    port, _, _ = runs
    rows = np.random.RandomState(10).standard_normal((RANKS * 40, 24)).astype(np.float32)
    want = qr_r(torch.from_numpy(rows)).numpy()
    for p in port:
        np.testing.assert_allclose(p["butterfly"], want, rtol=2e-4, atol=2e-4)
    assert all(np.array_equal(p["butterfly"], port[0]["butterfly"]) for p in port)


def test_distributed_tsqr_refuses_a_group_of_three(runs):
    port, _, _ = runs
    for p in port[:3]:
        assert p["three"] == "axis size 3 must be a power of two for butterfly TSQR"
    assert "three" not in port[3]


def test_sharded_qr_beats_gram_when_ill_conditioned(runs):
    """cond 1e9: the Gram's conditioning is 1e18 >> 1/eps32, so the
    distributed Gram sum degrades while the per-rank QR + butterfly stays
    near the fp64 oracle."""
    port, _, _ = runs
    x, w = _ill_conditioned()
    rank = ILL["rank"]
    w64, x64 = w.astype(np.float64), x.astype(np.float64)
    uu = np.linalg.svd(w64 @ x64)[0][:, :rank]
    w_ref = uu @ uu.T @ w64

    def rel(w_apx):
        return np.linalg.norm(np.asarray(w_apx, np.float64) - w_ref, 2) \
            / np.linalg.norm(w_ref, 2)

    wt = torch.from_numpy(w)
    coala_err = rel(coala_project(wt, r_factor=torch.from_numpy(port[0]["ill_r"]),
                                  rank=rank).numpy())
    a, b = baselines.svd_llm_v2(wt, torch.from_numpy(port[0]["ill_gram"]), rank)
    v2_err = rel((a @ b).numpy())
    assert coala_err < 1e-2, coala_err
    assert not np.isfinite(v2_err) or v2_err > 10 * coala_err, (coala_err, v2_err)


def test_split_batch_rows_and_refusal():
    b = {"tokens": torch.arange(24).reshape(4, 6),
         "frames": torch.zeros(4, 3, 2), "vision_embeds": torch.ones(4, 5, 2)}
    parts = split_batch(b, 2)
    assert [p["tokens"].tolist() for p in parts] == [b["tokens"][:2].tolist(),
                                                     b["tokens"][2:].tolist()]
    assert all(p["frames"].shape == (2, 3, 2) and p["vision_embeds"].shape == (2, 5, 2)
               for p in parts)
    assert [t.shape for t in split_batch(torch.zeros(8, 3), 4)] == [(2, 3)] * 4
    with pytest.raises(ValueError, match="batch rows 4 not divisible by 3 shards"):
        split_batch(b, 3)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_mesh_matches_single_device(runs):
    """``--mesh data=4 --device cpu --smoke`` against the port's own
    single-device run: the same pretrained model (base CE bit for bit), the
    sharded-calibration line, every rank's R bits equal, token counts equal,
    the compressed CE and reports at rtol 1e-4, and the numerics report on
    the ShardedCalibration."""
    (single, _), (mesh, text) = runs[2]
    assert "# sharded calibration: data=4 (butterfly TSQR reduce)" in text
    assert "# calibration numerics" in text and "resid/bound" in text
    cal = mesh["calibrator"]
    assert isinstance(cal, ShardedCalibration) and cal.n_shards == 4
    assert cal.tokens_seen() == single["calibrator"].tokens_seen()
    ranks = mesh["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert len({r["r_digest"] for r in ranks}) == 1
    assert all(r["bytes_sent"] == ranks[0]["bytes_sent"] > 0 for r in ranks)
    s, s1 = mesh["summary"], single["summary"]
    assert s["base_ce"] == s1["base_ce"]
    np.testing.assert_allclose(s["compressed_ce"], s1["compressed_ce"], rtol=1e-4)
    want = {r.path: r for r in single["reports"]}
    assert sorted(want) == sorted(r.path for r in mesh["reports"])
    for r in mesh["reports"]:
        np.testing.assert_allclose(r.rel_err_weighted, want[r.path].rel_err_weighted,
                                   rtol=1e-4)
        assert r.rank == want[r.path].rank


@pytest.mark.parametrize("value, message", [
    ("data=3", "--mesh data=3: shard count must be a power of two (butterfly TSQR pairing)"),
    ("data=16", "--mesh data=16: must divide the calibration batch of 8 rows"),
    ("model=2", "--mesh 'model=2' not understood; expected 'data=N' (calibration "
                "shards over the data axis)"),
    ("data=x", "--mesh 'data=x' not understood"),
])
def test_launcher_refuses_a_bad_mesh_before_pretraining(monkeypatch, capsys, value,
                                                       message):
    def never(*a, **k):
        raise AssertionError("reached pretraining")

    monkeypatch.setattr(launch_compress, "make_train_state", never)
    with pytest.raises(SystemExit) as e:
        launch_compress.main(LAUNCH + ["--mesh", value])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_mesh_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        launch_compress.main(["--smoke", "--mesh", "data=4"])


def test_group_run_raises_for_a_failing_rank():
    """A rank that raises makes the whole run raise, with its traceback."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1:.*ValueError: rank 1 fails"):
        group.run(2, _fail_on_one, device="cpu", timeout=60)
    assert not dist.is_initialized()


def _fail_on_one():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
    return math.pi


# ---------------------------------------------------------------------------
# the kernel build under ranks that load at once
# ---------------------------------------------------------------------------

FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "start $$" >> "$NVCC_LOG"
sleep 0.3
echo object > "$out"
echo "end $$" >> "$NVCC_LOG"
"""

BUILD_SCRIPT = """
import sys
from pathlib import Path
from repro_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build())
"""


def test_build_lock_makes_one_build_for_two_processes(tmp_path):
    """Two processes that build at once (a fake nvcc that takes 0.3 s a
    call): one compiles and links, the other waits on the lock and finds
    its library, so nvcc runs once per source and once to link, not
    twice."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, CUDA_HOME=str(cuda), NVCC_LOG=str(log),
               PYTHONPATH=str(REPO / "src"))
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).read_text() == "object\n"
    lines = log.read_text().split()
    pids = set(lines[1::2])
    from repro_torch.kernels import _build
    assert len(lines) == 2 * 2 * (len(_build.SOURCES) + 1)    # one build: 5 + link
    assert len(pids) == len(_build.SOURCES) + 1
    assert sorted(p.name for p in build.iterdir()) == [
        ".build.lock", Path(outs[0][0].strip()).name]        # no temporary left
